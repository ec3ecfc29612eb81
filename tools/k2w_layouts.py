"""Time K2w's two layouts of W for its 'cat' impute kernel at a schema
both take, on one GPU: W staged in shared memory a class tile at a time
(the fused entry up to P = 1,024) and W read from device memory (the
impute entry past 1,024, `sigma_fused.impute_wide`), and hold their codes
against each other bit for bit.

    python3 tools/k2w_layouts.py [--rows N] [--reps R]

The table is `chip_smoke.py`'s favorita_wide (P = 492) at `--rows` rows
(default 10M), imputing family (R = 33) and class (R = 337, 20% of its rows
null) from LDA coefficients trained on the table, as `[K2w]` does. Each
layout's impute kernel is timed alone by the profiler's device time of
that kernel (`impute_cat_tiles_kernel`), in the order tiled, global,
global, tiled; the global one also by CUDA events around its launch. Prints
the card and its power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def kernel_ms(fn, reps: int, name: str) -> float | None:
    """Mean device ms a call of the kernels whose name holds `name`, by
    torch.profiler over `reps` calls after one warm-up; None when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / reps / 1e3 if total > 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2w_layouts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, impute_wide, impute_wide_inputs)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_device(), flush=True)
    n = args.rows
    t = init_fill(cs.make_favorita(n, 13)[0])
    schema = t.schema
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(14)
    null_cls = torch.rand(n, generator=gen, device=cs.DEVICE) < 0.2
    w_fam, w_tx = (~t.cat_null[1]).float(), (~t.num_null[1]).float()
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    out = {"rows": n, "P": schema.sigma_size}
    for name, col, null, w_train, w_next in (
            ("family R=33", 1, t.cat_null[1], w_fam, w_tx),
            ("class R=337", 2, null_cls, (~null_cls).float(), w_fam)):
        sig = masked_gram_cols(xs, cs_, w_train, schema=schema)
        w, icpt, keep = _lda_device(sig, schema, col, 0.001)
        wf = _w_full(w, keep, schema)
        r = schema.cat_sizes[col]
        del sig
        tiled_codes, _ = fused_impute_aggregate(
            xs, cs_, null, w_next, wf, icpt, schema=schema, kind="cat",
            imp_col=col)
        inputs = impute_wide_inputs(wf, icpt, r, "cat", n, schema, cs.DEVICE)
        glob_codes = torch.empty_like(tiled_codes)

        def tiled():
            fused_impute_aggregate(xs, cs_, null, w_next, wf, icpt,
                                   schema=schema, kind="cat", imp_col=col)

        def global_():
            impute_wide(lib, xs, cs_, null, inputs[0], icpt, *inputs[1:],
                        glob_codes, r, "cat", col, None, 0, None, n, schema,
                        cs.DEVICE, stream)

        global_()
        torch.cuda.synchronize()
        same = torch.equal(tiled_codes, glob_codes)
        kern = "impute_cat_tiles_kernel"
        t1 = kernel_ms(tiled, args.reps, kern)
        g1 = kernel_ms(global_, args.reps, kern)
        g2 = kernel_ms(global_, args.reps, kern)
        t2 = kernel_ms(tiled, args.reps, kern)
        ev = cs.cuda_ms(global_, reps=args.reps, warmup=2)
        out[name] = dict(codes_identical=same, tiled_ms=[t1, t2],
                         global_ms=[g1, g2], global_event_ms=ev,
                         nulls=int(null.sum()),
                         tile_plan=list(_build.impute_plan(schema, r)),
                         global_plan=list(inputs[2]))
        print(f"[k2w_layouts] {name}: codes identical {same}; impute kernel "
              f"(profiler device ms) tiled {t1}, {t2}; global {g1}, {g2}; "
              f"global by CUDA events {ev:.4f} ms", flush=True)
        del tiled_codes, glob_codes, inputs
    print(json.dumps(out), flush=True)
    return 0 if all(v["codes_identical"] for k, v in out.items()
                    if isinstance(v, dict)) else 2


if __name__ == "__main__":
    sys.exit(main())
