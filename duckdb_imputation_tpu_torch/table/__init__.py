from .table import Table, from_numpy, from_pandas, from_reference
from .native import (CsvStream, NativeTable, csv_chunk_source,
                     format_csv_block, load_csv, read_csv)

__all__ = ["Table", "from_numpy", "from_pandas", "from_reference",
           "CsvStream", "NativeTable", "csv_chunk_source", "format_csv_block",
           "load_csv", "read_csv"]
