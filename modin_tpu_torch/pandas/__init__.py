"""The pandas API of the torch port: ``import modin_tpu_torch.pandas as pd``.

The slices the port runs today: ``DataFrame``/``Series`` construction and
``from_pandas``/``to_pandas``, arithmetic, comparisons and the logical
``&``/``|``/``^``/``~``, ``abs``, ``sum``/``mean``/``count``/``min``/``max``,
``groupby(keys)`` with ``count``/``size``/``sum``/``mean``/``min``/``max``,
boolean filters and ``query``, ``sort_values``, ``merge``, ``concat``,
``__setitem__``/``insert`` and ``isin``.  What the device paths do not take
defaults to pandas (see the query compiler).
"""

from modin_tpu_torch.pandas.dataframe import DataFrame
from modin_tpu_torch.pandas.general import concat, merge
from modin_tpu_torch.pandas.series import Series
from modin_tpu_torch.pandas.utils import from_pandas, to_pandas

__all__ = ["DataFrame", "Series", "concat", "from_pandas", "merge", "to_pandas"]
