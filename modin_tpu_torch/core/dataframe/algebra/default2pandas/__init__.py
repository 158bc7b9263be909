"""Default-to-pandas methods (reference: modin/core/dataframe/algebra/default2pandas/)."""

from modin_tpu_torch.core.dataframe.algebra.default2pandas.default import (  # noqa: F401
    BinaryDefault,
    CatDefault,
    DataFrameDefault,
    DateTimeDefault,
    DefaultMethod,
    EwmDefault,
    ExpandingDefault,
    GroupByDefault,
    ListDefault,
    ResampleDefault,
    RollingDefault,
    SeriesDefault,
    StrDefault,
    StructDefault,
)
