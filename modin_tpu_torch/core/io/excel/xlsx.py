"""Dependency-free xlsx reader and writer (a SpreadsheetML subset).

The port's copy of ``modin_tpu/core/io/excel/xlsx.py``, the codec that
``read_excel`` and ``to_excel`` fall back to where no Excel engine
(openpyxl, xlrd, calamine, pyxlsb) is installed.  An xlsx file is a zip of
XML parts: worksheet cells, a shared-string table, and a style table whose
number formats mark date cells.  The subset covers what
``DataFrame.to_excel``/``read_excel`` write and read for tabular data:
numbers, booleans, inline and shared strings, datetimes (serial + date
style) and blanks.

Reading streams the worksheet with ``xml.etree.iterparse`` (constant memory
in rows) and then applies pandas' header/skiprows/names semantics.
"""

from __future__ import annotations

import datetime as _dt
import io as _io
import re
import zipfile
from typing import Any, List, Optional, Union
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

import numpy as np
import pandas

_MAIN_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_REL_NS = "{http://schemas.openxmlformats.org/package/2006/relationships}"
# Excel's day-zero (the 1900 leap-year bug makes it Dec 30, 1899)
_EPOCH = _dt.datetime(1899, 12, 30)
# builtin numFmt ids that render as dates/times
_DATE_FMT_IDS = set(range(14, 23)) | set(range(45, 48))
_DATE_TOKEN_RE = re.compile(r"(?<!\\)[ymdhs]|AM/PM", re.IGNORECASE)


def _col_letter(idx: int) -> str:
    """0-based column index -> Excel letters (0 -> A, 27 -> AB)."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _col_index(ref: str) -> int:
    """Cell reference -> 0-based column index ("B7" -> 1)."""
    idx = 0
    for ch in ref:
        if ch.isdigit():
            break
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


# ---------------------------------------------------------------------- #
# Writer
# ---------------------------------------------------------------------- #

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
<Relationship Id="rId2" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/styles" Target="styles.xml"/>
</Relationships>"""

# style 0: General; style 1: builtin date-time format 22 ("m/d/yy h:mm")
_STYLES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<fonts count="1"><font/></fonts>
<fills count="1"><fill/></fills>
<borders count="1"><border/></borders>
<cellStyleXfs count="1"><xf/></cellStyleXfs>
<cellXfs count="2"><xf numFmtId="0"/><xf numFmtId="22" applyNumberFormat="1"/></cellXfs>
</styleSheet>"""


def _workbook_xml(sheet_name: str) -> str:
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f'<sheets><sheet name="{escape(str(sheet_name), {chr(34): "&quot;"})}" sheetId="1" r:id="rId1"/></sheets>'
        "</workbook>"
    )


def _cell_xml(ref: str, value: Any) -> str:
    """One <c> element, or '' for missing values (blank cell)."""
    try:
        if value is None or pandas.isna(value):  # None / NaN / NaT / pd.NA
            return ""
    except (TypeError, ValueError):  # non-scalar (e.g. a list cell value)
        pass
    if isinstance(value, (bool, np.bool_)):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (_dt.datetime, np.datetime64, pandas.Timestamp)):
        ts = pandas.Timestamp(value)
        if ts is pandas.NaT:
            return ""
        serial = (ts.to_pydatetime(warn=False) - _EPOCH).total_seconds() / 86400.0
        return f'<c r="{ref}" s="1"><v>{serial!r}</v></c>'
    if isinstance(value, (int, np.integer)):
        return f'<c r="{ref}"><v>{int(value)}</v></c>'
    if isinstance(value, (float, np.floating)):
        return f'<c r="{ref}"><v>{float(value)!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def write_xlsx(
    df: pandas.DataFrame,
    path: Any,
    sheet_name: str = "Sheet1",
    index: bool = True,
    header: bool = True,
) -> None:
    """Write a pandas DataFrame as a single-sheet xlsx file."""
    rows: List[str] = []
    r = 0

    def emit(values: list) -> None:
        nonlocal r
        r += 1
        cells = "".join(
            _cell_xml(f"{_col_letter(ci)}{r}", v) for ci, v in enumerate(values)
        )
        rows.append(f'<row r="{r}">{cells}</row>')

    index_width = df.index.nlevels if index else 0
    if header:
        for level in range(df.columns.nlevels):
            labels = [
                c[level] if df.columns.nlevels > 1 else c for c in df.columns
            ]
            emit([None] * index_width + list(labels))
    for idx_val, row in zip(df.index, df.itertuples(index=False, name=None)):
        prefix = (
            list(idx_val) if index and df.index.nlevels > 1 else [idx_val]
        ) if index else []
        emit(prefix + list(row))

    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(rows)}</sheetData></worksheet>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", _CONTENT_TYPES)
        zf.writestr("_rels/.rels", _ROOT_RELS)
        zf.writestr("xl/workbook.xml", _workbook_xml(sheet_name))
        zf.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        zf.writestr("xl/styles.xml", _STYLES)
        zf.writestr("xl/worksheets/sheet1.xml", sheet)


# ---------------------------------------------------------------------- #
# Reader
# ---------------------------------------------------------------------- #


def _shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    out: List[str] = []
    for _event, el in ET.iterparse(_io.BytesIO(data), events=("end",)):
        if el.tag == f"{_MAIN_NS}si":
            # concatenate every <t> below (plain or rich-text runs)
            out.append("".join(t.text or "" for t in el.iter(f"{_MAIN_NS}t")))
            el.clear()
    return out


def _date_styles(zf: zipfile.ZipFile) -> set:
    """Indices into cellXfs whose number format renders as a date."""
    try:
        root = ET.fromstring(zf.read("xl/styles.xml"))
    except KeyError:
        return set()
    custom_date_ids = set()
    for fmt in root.iter(f"{_MAIN_NS}numFmt"):
        code = fmt.get("formatCode", "")
        # strip quoted literals/colors, then look for date tokens
        bare = re.sub(r'"[^"]*"|\[[^\]]*\]', "", code)
        if _DATE_TOKEN_RE.search(bare):
            custom_date_ids.add(int(fmt.get("numFmtId")))
    date_styles = set()
    cell_xfs = root.find(f"{_MAIN_NS}cellXfs")
    if cell_xfs is not None:
        for i, xf in enumerate(cell_xfs.findall(f"{_MAIN_NS}xf")):
            fmt_id = int(xf.get("numFmtId", "0"))
            if fmt_id in _DATE_FMT_IDS or fmt_id in custom_date_ids:
                date_styles.add(i)
    return date_styles


def _required_member(zf: zipfile.ZipFile, name: str) -> bytes:
    """Read a member every OOXML workbook must have; a zip without it is not
    an xlsx file, which callers report as BadZipFile (not a bare KeyError)."""
    try:
        return zf.read(name)
    except KeyError as err:
        raise zipfile.BadZipFile(
            f"not an OOXML workbook: missing archive member {name!r}"
        ) from err


def _sheet_target(zf: zipfile.ZipFile, sheet_name: Union[int, str]) -> str:
    wb = ET.fromstring(_required_member(zf, "xl/workbook.xml"))
    rels = ET.fromstring(_required_member(zf, "xl/_rels/workbook.xml.rels"))
    rid_ns = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}id"
    targets = {
        rel.get("Id"): rel.get("Target") for rel in rels.iter(f"{_REL_NS}Relationship")
    }
    sheets = [
        (s.get("name"), targets.get(s.get(rid_ns)))
        for s in wb.iter(f"{_MAIN_NS}sheet")
    ]
    if isinstance(sheet_name, int):
        if sheet_name >= len(sheets):
            raise ValueError(f"Worksheet index {sheet_name} is invalid, {len(sheets)} worksheets found")
        target = sheets[sheet_name][1]
    else:
        by_name = dict(sheets)
        if sheet_name not in by_name:
            raise ValueError(f"Worksheet named {sheet_name!r} not found")
        target = by_name[sheet_name]
    target = target.lstrip("/")
    return target if target.startswith("xl/") else f"xl/{target}"


def sheet_names(path_or_buf: Any) -> List[str]:
    with zipfile.ZipFile(path_or_buf) as zf:
        wb = ET.fromstring(_required_member(zf, "xl/workbook.xml"))
        return [s.get("name") for s in wb.iter(f"{_MAIN_NS}sheet")]


def _parse_value(cell: ET.Element, strings: List[str], date_styles: set) -> Any:
    ctype = cell.get("t", "n")
    if ctype == "inlineStr":
        return "".join(t.text or "" for t in cell.iter(f"{_MAIN_NS}t"))
    v = cell.find(f"{_MAIN_NS}v")
    if v is None or v.text is None:
        return None
    text = v.text
    if ctype == "s":
        return strings[int(text)]
    if ctype == "str":  # cached formula string
        return text
    if ctype == "b":
        return text.strip() in ("1", "true")
    if ctype == "e":  # error cell -> missing
        return None
    # numeric: date-styled serials become timestamps
    if int(cell.get("s", "0") or 0) in date_styles:
        return pandas.Timestamp(_EPOCH) + pandas.to_timedelta(
            round(float(text) * 86400, 6), unit="s"
        )
    try:
        return int(text)
    except ValueError:
        return float(text)


def _read_grid(path_or_buf: Any, sheet_name: Union[int, str]) -> List[list]:
    if isinstance(path_or_buf, zipfile.ZipFile):
        return _read_grid_from_zip(path_or_buf, sheet_name)
    with zipfile.ZipFile(path_or_buf) as zf:
        return _read_grid_from_zip(zf, sheet_name)


def _read_grid_from_zip(zf: zipfile.ZipFile, sheet_name: Union[int, str]) -> List[list]:
    # memoize the workbook-global tables on the (possibly multi-sheet) handle
    cache = getattr(zf, "_modin_xlsx_cache", None)
    if cache is None:
        cache = {"strings": _shared_strings(zf), "styles": _date_styles(zf)}
        zf._modin_xlsx_cache = cache
    strings = cache["strings"]
    date_styles = cache["styles"]
    target = _sheet_target(zf, sheet_name)
    grid: List[list] = []
    width = 0
    with zf.open(target) as fh:
        for _event, el in ET.iterparse(fh, events=("end",)):
            if el.tag != f"{_MAIN_NS}row":
                continue
            row_num = int(el.get("r", len(grid) + 1))
            while len(grid) < row_num - 1:
                grid.append([])
            values: list = []
            for cell in el.findall(f"{_MAIN_NS}c"):
                ref = cell.get("r")
                ci = _col_index(ref) if ref else len(values)
                while len(values) < ci:
                    values.append(None)
                values.append(_parse_value(cell, strings, date_styles))
            grid.append(values)
            width = max(width, len(values))
            el.clear()
    for row in grid:
        row.extend([None] * (width - len(row)))
    return grid


def _infer_column(values: list) -> Any:
    """Column-wise dtype inference matching the engine-backed read_excel."""
    non_null = [v for v in values if v is not None]
    if not non_null:
        return np.full(len(values), np.nan)
    types = {type(v) for v in non_null}
    if types <= {int}:
        if len(non_null) == len(values):
            return np.array(values, dtype=np.int64)
        return np.array(
            [np.nan if v is None else float(v) for v in values], dtype=np.float64
        )
    if types <= {int, float}:
        return np.array(
            [np.nan if v is None else float(v) for v in values], dtype=np.float64
        )
    if types <= {bool} and len(non_null) == len(values):
        return np.array(values, dtype=bool)
    if all(isinstance(v, pandas.Timestamp) for v in non_null):
        return pandas.DatetimeIndex(
            [pandas.NaT if v is None else v for v in values]
        )
    return np.array(values, dtype=object)


def read_xlsx(
    path_or_buf: Any,
    sheet_name: Union[int, str, None, list] = 0,
    header: Optional[int] = 0,
    names: Any = None,
    skiprows: Any = None,
    nrows: Optional[int] = None,
    usecols: Any = None,
    index_col: Optional[int] = None,
    dtype: Any = None,
) -> Union[pandas.DataFrame, dict]:
    """pandas.read_excel work-alike over the native parser (kwarg subset)."""
    if sheet_name is None or isinstance(sheet_name, list):
        all_names = sheet_names(path_or_buf)
        wanted = all_names if sheet_name is None else sheet_name
        return {
            name: read_xlsx(
                path_or_buf, name, header=header, names=names,
                skiprows=skiprows, nrows=nrows, usecols=usecols,
                index_col=index_col, dtype=dtype,
            )
            for name in wanted
        }
    grid = _read_grid(path_or_buf, sheet_name)
    if skiprows:
        if isinstance(skiprows, (int, np.integer)):
            grid = grid[int(skiprows):]
        else:
            grid = [row for i, row in enumerate(grid) if i not in set(skiprows)]
    columns: Any = None
    if header is not None:
        header_rows, grid = grid[: header + 1], grid[header + 1:]
        if header_rows:
            raw = header_rows[-1]
            columns = [
                f"Unnamed: {i}" if v is None else v for i, v in enumerate(raw)
            ]
    if nrows is not None:
        grid = grid[:nrows]
    width = max((len(r) for r in grid), default=len(columns or []))
    if columns is None:
        columns = list(range(width))
    width = max(width, len(columns))
    # duplicate headers mangle like the engine-backed readers: x, x.1, x.2
    seen: dict = {}
    labels = []
    for label in columns:
        n = seen.get(label, 0)
        seen[label] = n + 1
        labels.append(f"{label}.{n}" if n else label)
    arrays = [
        _infer_column([row[ci] if ci < len(row) else None for row in grid])
        for ci in range(len(labels))
    ]
    df = pandas.DataFrame(dict(enumerate(arrays)))
    df.columns = labels
    if names is not None:
        df.columns = names
    if usecols is not None:
        keep = [
            c for i, c in enumerate(df.columns)
            if i in usecols or c in usecols
        ]
        df = df[keep]
    if index_col is not None:
        if isinstance(index_col, (list, tuple)):
            df = df.set_index([df.columns[i] for i in index_col])
        else:
            df = df.set_index(df.columns[index_col])
    if dtype is not None:
        df = df.astype(dtype)
    return df
