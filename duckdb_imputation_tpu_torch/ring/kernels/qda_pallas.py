"""K3 and K3w: batched QDA scoring over each row's nonzero pairs, all
classes per row.

Counterpart of `duckdb_imputation_tpu/ring/kernels/qda_pallas.py`
(`qda_predict_pallas`, the Pallas kernel `_qda_predict_pallas`). With
z̃ = [1 ‖ x ‖ onehot(codes)] (P = 1 + d + V) every class scores as one
quadratic form in the layout of sigma,

    s_c = z̃ᵀ·A_c·z̃,   A_c = [[b_c, lin_cᵀ/2], [lin_c/2, quad_c]],

and the prediction is the first argmax (a tie goes to the lowest class;
a NaN score never wins). A row's z̃ has k = 1 + d + (its in-range codes)
nonzeros, so s_c needs only A_c's entries at the row's pairs of
nonzeros: the cells of K7's plan (`_build.WidePlan`: the dense block D of
[1 ‖ x], the keyed tables K_j, the cross tables C_jk), where a one-hot
diagonal shares the cell of its constant row (z_v² = z_v = z_0·z_v); the
scorer's plan (`_build.qda_plan`) lays each K_j out a-major.
`qda_tables` packs A_c into those cells, `nb_tables` builds naive Bayes's
diagonal A_c on a plan without C_jk tables; neither factors anything.
Naive Bayes's tables are built around a per-column centre m (`nb_center`)
and score z̃ of x − m: the scorer takes m as `shift` and subtracts it from
x in f64 as it loads x, so no shifted copy of x exists. Expanded around 0,
a class of variance ~1e-9 at a mean of ~1e3 holds μ/σ² ≈ 1e12 in one f32
cell, to ~6e4; around m its cells are small.

`qda_predict_kernel` launches the hand-written CUDA kernel
(`csrc/qda_predict.cu`) for CUDA tensors: K3 when the plan has one task,
K3w when it has several (one kernel); it takes its plain version,
`qda_predict_plain`, only for CPU tensors. Both multiply each f32 cell by
the row's values and add the terms in f64 in the plan's order (task,
slab, cell), round s_c to f32 once and compare, so their scores are
bit-identical.
"""
from __future__ import annotations

import functools

import torch

from ...schema import FeatureSchema
from . import _build


def _pack(a: torch.Tensor, plan: _build.WidePlan) -> torch.Tensor:
    """A f64[C, P, P] into the plan's cells, f64[C, task_base[T]]: a cell
    holding the pairs (i, j) of the plan's map gets Σ A[i, j] + A[j, i]
    over its pairs with i < j and A[i, i] over those with i = j, so that
    Σ_cells cell·z_i·z_j = z̃ᵀ·A·z̃ for every row."""
    e = plan.entries.to(a.device).long()
    i, j = e[:, 2], e[:, 3]
    vals = torch.where(i == j, a[:, i, i], a[:, i, j] + a[:, j, i])
    flat = plan.task_base.to(a.device)[e[:, 0]] + e[:, 1]
    cells = torch.zeros((a.shape[0], int(plan.task_base[-1])),
                        dtype=torch.float64, device=a.device)
    return cells.index_add_(1, flat, vals)


def qda_tables(quad, lin, intercept, *, schema: FeatureSchema):
    """(quad [C, m, m], lin [C, m], intercept [C]), m = P − 1 → (tables
    f32[C, cells], plan): A_c in f64, packed into the cells of
    `_build.qda_plan(schema)` and rounded once. −quad is taken as it is,
    singular or not: no factor, no eigendecomposition."""
    num_classes, p = quad.shape[0], schema.sigma_size
    a = torch.zeros((num_classes, p, p), dtype=torch.float64,
                    device=quad.device)
    a[:, 0, 0] = intercept.to(torch.float64)
    a[:, 0, 1:] = lin.to(torch.float64) / 2
    a[:, 1:, 0] = lin.to(torch.float64) / 2
    a[:, 1:, 1:] = quad.to(torch.float64)
    plan = _build.qda_plan(schema)
    return _pack(a, plan).to(torch.float32), plan


def nb_center(log_prior, mean) -> torch.Tensor:
    """Naive Bayes's per-column centre f32[d]: the prior-weighted mean of
    the class means, Σ_c prior_c·μ_c / Σ_c prior_c in f64 from log_prior
    [C] and mean [C, d] (0 where every prior is 0), rounded to f32 once,
    as the scorer subtracts it."""
    f64 = torch.float64
    prior = torch.exp(log_prior.to(f64))
    total = prior.sum()
    center = (prior[:, None] * mean.to(f64)).sum(0) / total.clamp(
        min=torch.finfo(f64).tiny)
    return torch.where(total > 0, center, 0.0).to(torch.float32)


def nb_tables(log_prior, mean, var, log_freq, *, schema: FeatureSchema,
              center=None):
    """Naive Bayes's scores as tables: s_c = log prior_c + Σ_num
    [−(x−μ)²/2σ² − ½log(2πσ²)] + Σ_cat log freq_c[code] is z̃ᵀ·A_c·z̃
    with −1/2σ² on the numeric diagonal, μ/σ² (halved into row and column
    0) on the numerics, log freq on the one-hot diagonal, and the x-free
    terms at (0, 0). All in f64 from log_prior [C], mean, var [C, d] (var
    > 0) and log_freq [C, V]; packed into `_build.qda_plan(schema,
    cross=False)`, whose cells are D and K_j only: each of the plan's map
    entries (i, j) gets its value of A_c straight, A[0, a] + A[a, 0] = μ/σ²
    at (0, a), with no dense A (33 × 4,559² f64, 5.5 GB, at favorita_items'
    family); the same values `_pack` would sum from it. center: f32[d] or
    None (0): the tables score x − center, with μ − center in place of μ
    (pass the same tensor to the scorer as `shift`). Returns (tables
    f32[C, cells], plan)."""
    f64 = torch.float64
    mean, var = mean.to(f64), var.to(f64)
    if center is not None:
        mean = mean - center.to(f64)
    num_classes, d = mean.shape[0], schema.num_cols
    plan = _build.qda_plan(schema, cross=False)
    e = plan.entries.to(mean.device).long()
    i, j = e[:, 2], e[:, 3]
    vals = torch.zeros((num_classes, e.shape[0]), dtype=f64,
                       device=mean.device)
    a00 = log_prior.to(f64) - 0.5 * (
        mean * mean / var + torch.log(2.0 * torch.pi * var)).sum(1)
    at = (i == 0) & (j == 0)
    vals[:, at] = a00[:, None]
    # (0, a): the halves A[0, a] + A[a, 0], summed as `_pack` sums them
    at = (i == 0) & (j >= 1) & (j <= d)
    vals[:, at] = (mean / var / 2 + mean / var / 2)[:, j[at] - 1]
    at = (i == j) & (i >= 1) & (i <= d)
    vals[:, at] = (-0.5 / var)[:, i[at] - 1]
    at = (i == j) & (i > d)                             # one-hot diagonal
    vals[:, at] = log_freq.to(f64)[:, i[at] - 1 - d]
    flat = plan.task_base.to(mean.device)[e[:, 0]] + e[:, 1]
    cells = torch.zeros((num_classes, int(plan.task_base[-1])), dtype=f64,
                        device=mean.device)
    return cells.index_add_(1, flat, vals).to(torch.float32), plan


def class_scores_plain(tables, plan: _build.WidePlan, x_num, codes, *,
                       schema: FeatureSchema, shift=None):
    """Each class's scores f64[n] in turn, as the kernel sums them: each
    row's cells in the plan's order (task, slab, cell), each term the cell
    times the row's values (z_a·z_b for D, z_a for K, 1 for C and CB), in
    f64, added in f64 one after another. A code outside [0, size) adds no
    cell, nor a code outside a CB slab's rows. shift: f32[d] or None,
    taken from x in f64 first. On naive Bayes's plan (cross=False) only
    D's row 0 and diagonal and K's row 0 are read: its other cells are
    zero. A slab's terms are formed together (up to TERMS_AT_ONCE of them)
    and added in order (`_add_in_order`)."""
    d = schema.num_cols
    ref = x_num if d else codes
    n, device = ref.shape[-1], ref.device
    f64 = torch.float64
    xs = [x.to(f64) for x in x_num]
    if shift is not None:
        xs = [x - s for x, s in zip(xs, shift.to(f64))]
    z = torch.stack([torch.ones(n, dtype=f64, device=device)] + xs)
    codes = [c.long() for c in codes]
    ok = [(c >= 0) & (c < size) for c, size in zip(codes, schema.cat_sizes)]
    table = tables.to(f64)
    s = torch.zeros((tables.shape[0], n), dtype=f64, device=device)

    for (kind, p0, p1, p2, p3, off, task, _), (*_, v_lo, v_hi) in zip(
            plan.slabs.tolist(), plan.slots.tolist()):
        at = int(plan.task_base[task]) + off
        if kind == _build.SLAB_D:                   # (a, b), b in [p1, p2)
            b = torch.tensor([b for b in range(p1, p2)
                              if plan.cross or p0 == 0 or b == p0],
                             dtype=torch.long, device=device)
            if b.numel():
                s = _add_in_order(s, table[:, at + b - p1, None]
                                  * (z[p0] * z[b])[None])
        elif kind in (_build.SLAB_K, _build.SLAB_KB):  # column p0, keys
            hit = ok[p0] & (codes[p0] >= p1) & (codes[p0] < p2)  # [p1, p2)
            key = at + torch.where(hit, codes[p0], p1) - p1
            # a-major; columns [p3, a_hi) (its slots' last; K's 0, 1 + d)
            a_lo, a_hi = p3, v_hi
            a_end = a_hi if plan.cross else min(a_hi, 1)
            for a0 in range(a_lo, a_end, TERMS_AT_ONCE):
                a = torch.arange(a0, min(a0 + TERMS_AT_ONCE, a_end),
                                 device=device)
                cell = key[None] + (a - a_lo)[:, None] * (p2 - p1)
                s = _add_in_order(s, torch.where(
                    hit, table[:, cell] * z[a][None], 0.0))
        else:           # key column p0, row column p1, keys [p2, p3)
            hit = ok[p0] & ok[p1] & (codes[p0] >= p2) & (codes[p0] < p3)
            if kind == _build.SLAB_CB:              # the slab's rows only
                hit &= (codes[p1] >= v_lo) & (codes[p1] < v_hi)
                rows = v_hi - v_lo
            else:
                v_lo, rows = 0, schema.cat_sizes[p1]
            u = torch.where(hit, codes[p0], p2) - p2
            v = torch.where(hit, codes[p1], v_lo) - v_lo
            s = s + torch.where(hit, table[:, at + u * rows + v] * z[0], 0.0)
    yield from s


TERMS_AT_ONCE = 32      # a K slab's terms `class_scores_plain` forms at once


def _add_in_order(s, terms):
    """s f64[C, n] plus terms f64[C, k, n], the terms added one after
    another in k."""
    for t in terms.unbind(1):
        s = s + t
    return s


def qda_predict_plain(tables, plan: _build.WidePlan, x_num, codes, *,
                      schema: FeatureSchema, shift=None) -> torch.Tensor:
    """Plain torch version of `qda_predict_kernel`: each class's scores
    from `class_scores_plain`, rounded to f32; classes stream with a
    running (best value, best index) pair and a strict `>`, as the JAX
    package's `_qda_predict_xla` does. Returns i32[n]."""
    ref = x_num if schema.num_cols else codes
    n, device = ref.shape[-1], ref.device
    best_v = torch.full((n,), -torch.inf, dtype=torch.float32, device=device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=device)
    for cc, s in enumerate(class_scores_plain(tables, plan, x_num, codes,
                                              schema=schema, shift=shift)):
        s = s.to(torch.float32)
        upd = s > best_v
        best_v = torch.where(upd, s, best_v)
        best_i = torch.where(upd, cc, best_i)
    return best_i


@functools.lru_cache(maxsize=32)
def _device_plan(d: int, sizes: tuple[int, ...], cross: bool, cap: int,
                 local: bool, device):
    """The scorer's plan on `device`: its slab records with a C or CB
    slab's rows (v_lo, v_hi) in place of the task and the warp, and in a
    local plan a D slab's two stage slots and a KB slab's end column and
    stage slot there; warp_begin, task_base and the stage lists."""
    plan = _build._wide_plan(d, sizes, cross, True, cap, local)
    slabs, slots = plan.slabs.clone(), plan.slots
    kind = slabs[:, 0]
    c = (kind == _build.SLAB_C) | (kind == _build.SLAB_CB)
    slabs[c, 6:8] = slots[c, 2:4]
    if local:
        slabs[kind == _build.SLAB_D, 6:8] = slots[kind == _build.SLAB_D, :2]
        kb = kind == _build.SLAB_KB
        slabs[kb, 6], slabs[kb, 7] = slots[kb, 3], slots[kb, 1]
    return tuple(t.to(device) for t in (slabs, plan.warp_begin,
                                         plan.task_base, plan.stage_cols))


def qda_predict_kernel(tables, plan: _build.WidePlan, x_num, codes, *,
                       schema: FeatureSchema, shift=None) -> torch.Tensor:
    """First-argmax class index i32[n] of the scores z̃ᵀ·A_c·z̃ over
    x_num f32[d, n] and codes i32[c, n]; tables f32[C, cells] and plan as
    `qda_tables` or `nb_tables` return them; shift: f32[d] taken from x
    as it is loaded (the `center` of `nb_tables`), or None.

    CUDA tensors launch the kernel: counted in `qda_predict_kernel.
    launches` (K3) when the plan has one task, else in
    `qda_predict_kernel.wide_launches` (K3w); the plan must be the
    scorer's (`_build.qda_plan`) and the tables 16-byte aligned. CPU
    tensors take the plain version."""
    tensors = [tables, x_num, codes] + ([] if shift is None else [shift])
    if _build.on_cpu(tensors):
        return qda_predict_plain(tables, plan, x_num, codes, schema=schema,
                                 shift=shift)
    num_classes = tables.shape[0]
    n = x_num.shape[-1] if schema.num_cols else codes.shape[-1]
    _build.check_qda(schema, num_classes, n, plan.cross)
    if not plan.scorer or tables.data_ptr() % 16:
        raise ValueError("qda_predict_kernel takes tables of a "
                         "`_build.qda_plan` at a 16-byte aligned address")
    cells = int(plan.task_base[-1])
    device = _build.check_cuda(
        tensors,
        [(tables, torch.float32, (num_classes, cells), "tables"),
         (x_num, torch.float32, (schema.num_cols, n), "x_num"),
         (codes, torch.int32, (schema.cat_cols, n), "codes")]
        + ([] if shift is None
           else [(shift, torch.float32, (schema.num_cols,), "shift")]))
    slabs, warp_begin, task_base, stage_cols = _device_plan(
        schema.num_cols, tuple(schema.cat_sizes), plan.cross,
        plan.task_cells, plan.local, device)
    threads, rows, group = _build.qda_tile(schema, plan, num_classes)
    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_qda_predict(
            *_build.column_args(list(x_num), list(codes), sizes, device),
            tables.data_ptr(), slabs.data_ptr(),
            warp_begin.data_ptr(), task_base.data_ptr(), num_classes,
            plan.num_tasks, plan.max_task_cells, cells, n, threads, rows,
            group, int(not plan.cross),
            int(bool((plan.slabs[:, 0] == _build.SLAB_CB).any())),
            None if shift is None else shift.data_ptr(),
            stage_cols.data_ptr(), stage_cols.shape[1],
            plan.max_stage_x if plan.local else 0, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "qda_predict_kernel")
    if plan.num_tasks == 1:
        qda_predict_kernel.launches += 1
    else:
        qda_predict_kernel.wide_launches += 1
    return out


qda_predict_kernel.launches = 0
qda_predict_kernel.wide_launches = 0
