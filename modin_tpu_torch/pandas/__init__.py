"""The pandas API of the torch port: ``import modin_tpu_torch.pandas as pd``.

The slice the port runs today: ``DataFrame``/``Series`` construction and
``from_pandas``/``to_pandas``, arithmetic and comparisons, ``abs``,
``sum``/``mean``/``count``/``min``/``max``, and ``groupby(keys)`` with
``count``/``size``/``sum``/``mean``/``min``/``max``.  What the device paths
do not take defaults to pandas (see the query compiler).
"""

from modin_tpu_torch.pandas.dataframe import DataFrame
from modin_tpu_torch.pandas.series import Series
from modin_tpu_torch.pandas.utils import from_pandas, to_pandas

__all__ = ["DataFrame", "Series", "from_pandas", "to_pandas"]
