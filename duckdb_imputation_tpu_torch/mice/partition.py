"""MICE initialization on the table's device.

Counterpart of `duckdb_imputation_tpu.mice.partition.init_fill`: mean-fill
numeric nulls, mode-fill categorical nulls (AVG/MODE fill of the
reference's partition.cpp:42-57, init_baseline :671-719). The JAX package
does this on the host in numpy f64; here it runs on the device that holds
the table, so a 10M-row table never round-trips through host memory.
"""
from __future__ import annotations

import dataclasses

import torch

from ..table.table import Table


def init_fill(t: Table) -> Table:
    """Mean-fill numeric nulls (means accumulated in f64), mode-fill
    categorical nulls. The mode is `bincount(...).argmax()`: a tie goes to
    the lowest code, as `np.argmax` does in the JAX package."""
    num = t.num_data.clone()
    for j in range(num.shape[0]):
        obs = ~t.num_null[j]
        cnt = obs.sum()
        total = torch.where(obs, t.num_data[j].double(), 0.0).sum()
        mean = torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)
        num[j] = torch.where(t.num_null[j], mean.float(), num[j])
    codes = t.cat_codes.clone()
    for j in range(codes.shape[0]):
        obs = t.cat_codes[j][~t.cat_null[j]]
        mode = (torch.bincount(obs).argmax().to(codes.dtype) if obs.numel()
                else torch.zeros((), dtype=codes.dtype, device=codes.device))
        codes[j] = torch.where(t.cat_null[j], mode, codes[j])
    return dataclasses.replace(t, num_data=num, cat_codes=codes)
