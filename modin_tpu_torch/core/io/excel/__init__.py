from modin_tpu_torch.core.io.excel.xlsx import read_xlsx, sheet_names, write_xlsx

__all__ = ["read_xlsx", "sheet_names", "write_xlsx"]
