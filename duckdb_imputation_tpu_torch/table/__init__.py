from .table import Table, from_numpy, from_pandas, from_reference

__all__ = ["Table", "from_numpy", "from_pandas", "from_reference"]
