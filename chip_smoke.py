"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the main path of `duckdb_imputation_tpu_torch` — `run_mice_device`
with the unfused loop over the masked-Gram kernel (K1) and the fused loop
over the fused impute+aggregate kernel (K2) — at the schema of BASELINE.md
config 5 (4 numeric columns, two categorical columns of 8: P = 21) and 10M
rows, then one fused round at the deployment scale of 100M rows. First it
builds the kernels from `duckdb_imputation_tpu_torch/csrc/` and holds each
against its plain torch version at the shapes the main path gives it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Prints one line per phase, then a JSON
line of per-kernel results, then the device as the last line. Any failed
check raises and ends the run with a nonzero exit; so does a machine
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

N = 10_000_000
N_RAGGED = N + 12_345
N_DEPLOY = 100_000_000
ROUNDS = 3
DEVICE = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms of fn() over `reps` calls, by CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def make_table(n: int, seed: int, *, noise_fixture: bool = False):
    """The BASELINE config-5 table, made on the device from `seed`: x1 is
    linear in x0 and x2 (x1 = 3·x0 + x2; with noise_fixture, x1 = 2·x0 +
    0.5·eps), c0 is predictable from x0, 20% nulls in numeric column 1 and
    categorical column 0. Returns (table, true x1)."""
    from duckdb_imputation_tpu_torch import FeatureSchema, Table

    dev = DEVICE
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn():
        return torch.randn(n, generator=g, device=dev)

    z0, z1 = randn(), randn()
    if noise_fixture:
        x = torch.stack([z0, 2 * z0 + 0.5 * z1, randn(), randn()])
    else:
        x = torch.stack([z0, 2 * z0 + z1, z1 - z0, randn()])
    c0 = torch.clamp(z0 + 4.0, 0, 7).to(torch.int32)
    c1 = torch.randint(0, 8, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    codes = torch.stack([c0, c1])
    num_null = torch.zeros((4, n), dtype=torch.bool, device=dev)
    cat_null = torch.zeros((2, n), dtype=torch.bool, device=dev)
    num_null[1] = torch.rand(n, generator=g, device=dev) < 0.2
    cat_null[0] = torch.rand(n, generator=g, device=dev) < 0.2
    truth = x[1].clone()
    x = torch.where(num_null, 0.0, x)
    codes = torch.where(cat_null, 0, codes)
    schema = FeatureSchema(num_cols=4,
                           cat_keys=(tuple(range(8)), tuple(range(8))))
    return Table(num_data=x, cat_codes=codes, num_null=num_null,
                 cat_null=cat_null, schema=schema), truth


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count "
        f"{torch.cuda.device_count()}")
    log(card)


def phase_build():
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[build] {lib.path.name} nvcc {lib.build_seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")


def count_entries(schema):
    """Mask of the sigma entries that are integer counts: N, the one-hot
    counts and the one-hot cross counts."""
    p, d = schema.sigma_size, schema.num_cols
    m = torch.zeros((p, p), dtype=torch.bool, device=DEVICE)
    m[0, 0] = True
    m[0, 1 + d:] = True
    m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def phase_k1(seed: int) -> dict:
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_cols_plain)

    t, _ = make_table(N_RAGGED, seed)
    schema = t.schema
    x_cols = list(t.num_data.unbind(0))
    codes = t.cat_codes.clone()
    codes[0, :1000] = 8          # out of vocab: the encode() miss code
    codes[1, 1000:2000] = -1     # negative: contributes nothing either
    code_cols = list(codes.unbind(0))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1)
    w = (torch.rand(N_RAGGED, generator=g, device=DEVICE) >= 0.2).float()
    counts = count_entries(schema)
    out = {}
    for n in (N, N_RAGGED):
        xs = [c[:n] for c in x_cols]
        cs = [c[:n] for c in code_cols]
        got = masked_gram_cols(xs, cs, w[:n], schema=schema)
        again = masked_gram_cols(xs, cs, w[:n], schema=schema)
        want = masked_gram_cols_plain(xs, cs, w[:n], schema=schema)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all(), "K1 sigma not finite")
        check(torch.equal(got, again), "K1 repeated run not bit-identical")
        check(torch.equal(got[counts], want[counts]),
              "K1 counts differ from the plain version")
        check(float(got[0, 0]) == float(w[:n].sum()), "K1 sigma[0,0] != Σw")
        err = rel_err(got, want)
        check(err <= 1e-5, f"K1 max rel error {err:.3e} > 1e-5")
        ms = cuda_ms(lambda: masked_gram_cols(xs, cs, w[:n], schema=schema))
        plain_ms = cuda_ms(
            lambda: masked_gram_cols_plain(xs, cs, w[:n], schema=schema),
            reps=3, warmup=1)
        log(f"[K1] n={n}: counts exact, max rel err {err:.3e} (of max|σ|),"
            f" max abs err {float((got - want).abs().max()):.3e}, "
            f"bit-identical rerun; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms")
        if n == N:
            out = dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                       plain_ms=plain_ms)
    return out


def phase_k2(seed: int) -> dict:
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _noise_std, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t = init_fill(make_table(N, seed)[0])
    schema = t.schema
    x_cols = list(t.num_data.unbind(0))
    code_cols = list(t.cat_codes.unbind(0))
    w_c0 = (~t.cat_null[0]).float()
    w_x1 = (~t.num_null[1]).float()

    sig = masked_gram_cols(x_cols, code_cols, w_c0, schema=schema)
    w, icpt, keep = _lda_device(sig, schema, 0, 0.001)
    cat_args = (x_cols, code_cols, t.cat_null[0], w_x1,
                _w_full(w, keep, schema), icpt)
    cat_kw = dict(schema=schema, kind="cat", imp_col=0)
    new_k, sig_k = fused_impute_aggregate(*cat_args, **cat_kw)
    new_p, sig_p = fused_impute_aggregate_plain(*cat_args, **cat_kw)
    torch.cuda.synchronize()
    agree = float((new_k == new_p).float().mean())
    err = rel_err(sig_k, sig_p)
    abs_err = float((sig_k - sig_p).abs().max())
    check(agree >= 0.9999, f"K2 cat code agreement {agree}")
    check(err <= 1e-5, f"K2 cat sigma rel err {err:.3e} > 1e-5")
    ms = cuda_ms(lambda: fused_impute_aggregate(*cat_args, **cat_kw))
    plain_ms = cuda_ms(lambda: fused_impute_aggregate_plain(*cat_args,
                                                            **cat_kw),
                       reps=3, warmup=1)
    log(f"[K2] cat step n={N}: code agreement {agree:.6f}, sigma max rel "
        f"err {err:.3e}, max abs err {abs_err:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")

    sig_x = masked_gram_cols(x_cols, code_cols, w_x1, schema=schema)
    coeff = linreg_solve_device(sig_x, label=2)
    theta = coeff.clone()
    theta[2] = 0.0
    std = _noise_std(coeff, sig_x)
    for noise in (None, (seed, 0, std)):
        num_args = (x_cols, code_cols, t.num_null[1], w_c0, theta[:, None],
                    theta.new_zeros(1))
        num_kw = dict(schema=schema, kind="num", imp_col=1, noise=noise)
        nk, sk = fused_impute_aggregate(*num_args, **num_kw)
        np_, sp = fused_impute_aggregate_plain(*num_args, **num_kw)
        torch.cuda.synchronize()
        dx = float((nk - np_).abs().max())
        e = rel_err(sk, sp)
        check(torch.isfinite(nk).all(), "K2 num column not finite")
        check(dx <= 1e-4, f"K2 num max|Δx| {dx:.3e} > 1e-4")
        check(e <= 1e-5, f"K2 num sigma rel err {e:.3e} > 1e-5")
        k_ms = cuda_ms(lambda: fused_impute_aggregate(*num_args, **num_kw))
        log(f"[K2] num step n={N} noise={noise is not None}: max|Δx| "
            f"{dx:.3e}, sigma max rel err {e:.3e}; kernel {k_ms:.4f} ms")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)


def phase_reference(seed: int) -> None:
    """The fused loop on the card against the plain loop on the CPU at a
    small size."""
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.table import Table

    t, _ = make_table(200_000, seed)
    cpu = Table(*(a.cpu() for a in (t.num_data, t.cat_codes, t.num_null,
                                    t.cat_null)), schema=t.schema)
    ref = run_mice_device(cpu, iters=2, kernel="plain")
    got = run_mice_device(t, iters=2, kernel="fused")
    m = t.cat_null[0].cpu()
    agree = float((got.cat_codes[0].cpu() == ref.cat_codes[0])[m]
                  .float().mean())
    dx = float((got.num_data.cpu() - ref.num_data).abs().max())
    check(agree >= 0.999 and dx < 1e-2,
          f"fused (GPU) vs plain (CPU): agreement {agree}, x diff {dx}")
    log(f"[reference] n=200000 fused on the card vs plain on the CPU: "
        f"code agreement {agree:.6f}, x max diff {dx:.3e}")


def phase_main_path(seed: int) -> dict:
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.mice.device_round import (
        mice_loop_device, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t, truth = make_table(N, seed)
    torch.cuda.synchronize()
    masked_gram_cols.launches = 0
    fused_impute_aggregate.launches = 0
    unf = run_mice_device(t, iters=ROUNDS, kernel="gram")
    fus = run_mice_device(t, iters=ROUNDS, kernel="fused")
    torch.cuda.synchronize()
    launches = {"masked_gram_cols": masked_gram_cols.launches,
                "fused_impute_aggregate": fused_impute_aggregate.launches}
    log(f"[main] run_mice_device n={N} rounds={ROUNDS} (gram, then fused): "
        f"launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")

    for name, out in (("gram", unf), ("fused", fus)):
        check(out.num_data.shape == t.num_data.shape
              and out.cat_codes.shape == t.cat_codes.shape, "shape")
        check(torch.isfinite(out.num_data).all(), f"{name}: x not finite")
        check(torch.equal(out.num_data[0], t.num_data[0]),
              f"{name}: observed column changed")
    m = t.cat_null[0]
    agree = float((fus.cat_codes[0] == unf.cat_codes[0])[m].float().mean())
    dx = float((fus.num_data[1] - unf.num_data[1]).abs().max())
    nm = t.num_null[1]
    rmse = {k: float(((o.num_data[1] - truth)[nm] ** 2).mean().sqrt())
            for k, o in (("gram", unf), ("fused", fus))}
    check(agree >= 0.999, f"fused vs unfused code agreement {agree}")
    check(dx < 1e-2, f"fused vs unfused x max diff {dx}")
    check(max(rmse.values()) < 0.05, f"imputed x1 RMSE {rmse}")
    log(f"[main] fused vs unfused: code agreement {agree:.6f}, x max diff "
        f"{dx:.3e}; RMSE of imputed x1 vs truth {rmse}")

    f = init_fill(t)
    kw = dict(schema=t.schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(0,))
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    per_round = {}
    for name, loop in (
            ("gram", lambda k: mice_loop_device(*args, iters=k,
                                                kernel="gram", **kw)),
            ("fused", lambda k: mice_loop_device_fused(*args, iters=k,
                                                       **kw))):
        one = cuda_ms(lambda: loop(1), reps=3, warmup=1)
        four = cuda_ms(lambda: loop(4), reps=3, warmup=1)
        per_round[name] = (four - one) / 3
    log(f"[main] ms per round at n={N} (slope of 1 vs 4 rounds, CUDA "
        f"events): {per_round}")
    return launches


def phase_noise(seed: int) -> None:
    from duckdb_imputation_tpu_torch import run_mice_device

    t, _ = make_table(N, seed, noise_fixture=True)
    kw = dict(iters=2, kernel="fused")
    xn = run_mice_device(t, **kw).num_data
    xa = run_mice_device(t, noise=True, seed=seed, **kw).num_data
    xb = run_mice_device(t, noise=True, seed=seed, **kw).num_data
    xc = run_mice_device(t, noise=True, seed=seed + 7, **kw).num_data
    m = t.num_null[1]
    check(torch.equal(xa, xb), "same-seed noise not deterministic")
    check(not torch.equal(xa[1][m], xc[1][m]), "seed has no effect")
    d = (xa[1] - xn[1])[m].double()
    z = d / d.std().clamp(min=1e-9)
    std, mean = float(d.std()), float(d.mean())
    skew, kurt = float((z ** 3).mean()), float((z ** 4).mean())
    # the residual std of the x1 model is 0.5 (x1 = 2·x0 + 0.5·eps)
    check(0.4 < std < 0.6, f"noise std {std}")
    check(abs(mean) < 0.01, f"noise mean {mean}")
    check(abs(skew) < 0.1, f"noise skew {skew}")
    check(abs(kurt - 3.0) < 0.2, f"noise kurtosis {kurt}")
    log(f"[noise] fused n={N}: std {std:.4f}, mean {mean:.2e}, skew "
        f"{skew:.4f}, kurtosis {kurt:.4f}; same seed equal, other seed "
        f"differs")


def phase_deploy(seed: int) -> None:
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.mice.device_round import (
        mice_loop_device, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t, truth = make_table(N_DEPLOY, seed)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_mice_device(t, iters=1, kernel="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nm = t.num_null[1]
    rmse = float(((out.num_data[1] - truth)[nm] ** 2).mean().sqrt())
    check(torch.isfinite(out.num_data).all(), "100M: x not finite")
    check(rmse < 0.05, f"100M: imputed x1 RMSE {rmse}")
    del out

    # counts past 2**24 rows: K1 rounds the exact count to f32 once
    obs = ~t.num_null[1]
    sig = masked_gram_cols(list(t.num_data.unbind(0)),
                           list(t.cat_codes.unbind(0)), obs.float(),
                           schema=t.schema)
    exact = torch.cat([obs.sum().reshape(1), torch.bincount(
        t.cat_codes[1][obs].long(), minlength=8)]).double().float()
    got = torch.cat([sig[0, :1], sig[0, 1 + 4 + 8:]])
    check(torch.equal(got, exact), f"100M: K1 counts {got} != {exact}")
    f = init_fill(t)
    kw = dict(schema=t.schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(0,))
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    per_round = {}
    for name, loop in (
            ("gram", lambda k: mice_loop_device(*args, iters=k,
                                                kernel="gram", **kw)),
            ("fused", lambda k: mice_loop_device_fused(*args, iters=k,
                                                       **kw))):
        one = cuda_ms(lambda: loop(1), reps=2, warmup=1)
        three = cuda_ms(lambda: loop(3), reps=2, warmup=1)
        per_round[name] = (three - one) / 2
    log(f"[deploy] n={N_DEPLOY}: one fused run_mice_device round {wall:.3f}"
        f" s wall (init fill included), RMSE {rmse:.3e}; K1 counts equal"
        f" the exact counts rounded once to f32; table resident "
        f"{resident / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; ms per "
        f"round (slope of 1 vs 3 rounds): {per_round}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    phase_build()
    k1 = phase_k1(args.seed)
    k2 = phase_k2(args.seed)
    phase_reference(args.seed)
    launches = phase_main_path(args.seed)
    phase_noise(args.seed)
    phase_deploy(args.seed)

    kernels = [
        dict(name="masked_gram_cols", route="cuda",
             source="duckdb_imputation_tpu_torch/csrc/masked_gram.cu",
             replaces="duckdb_imputation_tpu/ring/kernels/sigma_pallas.py:888",
             launches=launches["masked_gram_cols"], **k1),
        dict(name="fused_impute_aggregate", route="cuda",
             source=("duckdb_imputation_tpu_torch/csrc/"
                     "fused_impute_aggregate.cu"),
             replaces="duckdb_imputation_tpu/ring/kernels/sigma_fused.py:413",
             launches=launches["fused_impute_aggregate"], **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
