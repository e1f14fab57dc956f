"""Wrappers and plain versions of the kernel probes P1 to P4.

P1 (``csrc/probe_fwd.cu``) is K1's own kernel under knockouts, P2
(``probe_bwd.cu``) K2's, P3 (``probe_load.cu``) K1's loads apart from its
math and an in-kernel gather, P4 (``probe_dtype.cu``) an elementwise op mix
in float32 and packed bfloat16.  The variants of P1, P2 and P3's
compute_resident are compile-time variants of K1's and K2's kernels
(``csrc/composite_fwd.cuh``, ``composite_bwd.cuh``), whose comments say what
each keeps and removes; the plain PyTorch versions here define every
output.

As everywhere in the port, a wrapper given CPU tensors returns its plain
version, and given CUDA tensors launches its kernel (counted in
``_kernels.launch_counts``) or raises.
"""
from __future__ import annotations

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import composite_cuda as comp
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MAX, ALPHA_MIN, T_EPS
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

FWD_VARIANTS = ("base", "no_cond", "no_scan", "no_matmul", "no_minmax",
                "alpha_only", "quad_power", "no_exp", "stripped",
                "trim_bookkeeping")
BWD_VARIANTS = ("base", "moments_basis", "exp", "no_alpha", "no_moments",
                "no_dfeat")
LOAD_VARIANTS = ("load_only", "load_only_4tiles", "compute_resident")
GATHER_VARIANTS = ("row_gather", "block_copy")
DTYPE_VARIANTS = ("f32", "bf16")
TILES_PER_CTA = 4              # load_only_4tiles
_GATHER_BASE = len(LOAD_VARIANTS)   # P3's enum: the gathers follow the loads


def _variant(name, names):
    _kernels.require(name in names, f"unknown variant {name!r}; one of "
                     f"{', '.join(names)}")
    return names.index(name)


def _launch(counter, fn_name, *args):
    lib = _kernels.lib()
    err = getattr(lib, fn_name)(*args)
    _kernels.check(err, fn_name)
    _kernels.launch_counts[counter] += 1


# ----------------------------------------------------------------- P1 ---

def probe_forward_plain(variant, table, gauss_id, starts, counts,
                        grid_x: int):
    """Plain version of P1's ``variant`` (``csrc/composite_fwd.cuh`` says
    what each removes): K1's packed [T, C+2, TILE_PIX] layout, walked like
    ``composite_cuda.composite_forward_plain``: tile batches, CHUNK
    instances at a time, the transmittance as a running product."""
    _variant(variant, FWD_VARIANTS)
    if variant == "quad_power":      # K1's mxu_power form
        return comp.composite_forward_plain(table, gauss_id, starts, counts,
                                            grid_x, comp.Form(mxu_power=True))
    strip = variant in ("stripped", "no_exp")
    terminate = variant not in ("alpha_only", "no_scan") and not strip
    one_channel = variant in ("no_matmul", "alpha_only")
    keep_last = variant not in ("no_minmax", "alpha_only") and not strip
    dev = table.device
    P, R = table.shape
    C = R - comp.ATTR_BASE
    num_tiles = starts.shape[0]
    table_p = torch.cat([table, table.new_zeros((1, R))])    # sentinel row P
    out = torch.zeros((num_tiles, C + 2, comp.TILE_PIX), dtype=torch.float32,
                      device=dev)
    tb = max(1, (1 << 25) // (comp.CHUNK * comp.TILE_PIX))
    ks = torch.arange(comp.CHUNK, dtype=torch.int32, device=dev)
    for t0 in range(0, num_tiles, tb):
        t1 = min(num_tiles, t0 + tb)
        n = t1 - t0
        px, py = comp.pixel_coords(torch.arange(t0, t1, device=dev), grid_x)
        st, cnt = starts[t0:t1], counts[t0:t1]
        Tc = torch.ones((n, comp.TILE_PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((n, comp.TILE_PIX), dtype=torch.bool, device=dev)
        acc = torch.zeros((n, 1 if one_channel else C, comp.TILE_PIX),
                          dtype=torch.float32, device=dev)
        last = torch.zeros((n, comp.TILE_PIX), dtype=torch.int32, device=dev)
        for c0 in range(0, int(cnt.max()) if n else 0, comp.CHUNK):
            if terminate and bool(done.all()):
                break
            pos = c0 + ks
            rows, valid, _ = comp._instance_rows(table_p, gauss_id, st, cnt,
                                                 pos, P)
            _, _, power, raw = comp.pair_terms(rows, px, py)
            if variant == "no_exp":
                raw = rows[:, :, 5, None] * (1.0 + power)
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            mask = (valid[:, :, None] & (power <= 0.0)
                    & (alpha >= ALPHA_MIN))
            a = torch.where(mask, alpha, 0.0)
            if variant == "alpha_only":
                acc[:, 0] += torch.sum(a, dim=1)
                continue
            if variant == "no_scan":
                contrib, w = mask, a                 # T stays 1
            else:
                if terminate:
                    mask = mask & ~done[:, None, :]
                    a = torch.where(mask, alpha, 0.0)
                T_run = torch.cumprod(
                    torch.cat([Tc[:, None, :], 1.0 - a], dim=1), dim=1)
                contrib = mask
                if terminate:
                    trigger = mask & (T_run[:, 1:] < T_EPS)
                    contrib = mask & (torch.cumsum(trigger.to(torch.int32), 1)
                                      == 0)
                    done = done | trigger.any(dim=1)
                    a = torch.where(contrib, a, 0.0)
                    T_run = torch.cumprod(
                        torch.cat([Tc[:, None, :], 1.0 - a], dim=1), dim=1)
                w = a * T_run[:, :-1]
                Tc = T_run[:, -1]
            if one_channel:
                acc[:, 0] += torch.sum(w, dim=1)
            else:
                for c in range(C):
                    acc[:, c] += torch.sum(
                        w * rows[:, :, comp.ATTR_BASE + c, None], dim=1)
            if keep_last:
                last = torch.maximum(last, torch.amax(
                    torch.where(contrib, pos[None, :, None] + 1, 0), dim=1))
        out[t0:t1, :acc.shape[1]] = acc
        out[t0:t1, C] = Tc
        out[t0:t1, C + 1] = last.to(torch.float32)
    return out


def probe_forward(variant, table, gauss_id, starts, counts, grid_x: int):
    """P1 wrapper: ``variant`` of K1 on K1's inputs (``composite_cuda.
    composite_forward``'s), output [T, C+2, TILE_PIX] f32."""
    v = _variant(variant, FWD_VARIANTS)
    comp._check_tile_inputs(table, gauss_id, starts, counts, grid_x)
    dev = table.device
    if dev.type == "cpu":
        return probe_forward_plain(variant, table, gauss_id, starts, counts,
                                   grid_x)
    _kernels.require(dev.type == "cuda", f"unsupported device {dev}")
    _kernels.require(comp.TILE_PIX <= comp._MAX_THREADS,
                     f"TILE_X*TILE_Y={comp.TILE_PIX} exceeds "
                     f"{comp._MAX_THREADS} threads")
    _kernels.require(comp.TILE_X % comp.PIX_PER_THREAD == 0,
                     f"P1 takes rows of a multiple of {comp.PIX_PER_THREAD} "
                     f"pixels, not TILE_X={comp.TILE_X} (K1 alone has a "
                     "kernel whose threads' pixels cross rows)")
    P, R = table.shape
    C = R - comp.ATTR_BASE
    # a batch's rows, cull masks and (quad_power) six coefficients each
    _kernels.require((comp._KERNEL_BATCH * (R + 1 + 6)) * 4
                     <= comp._SMEM_LIMIT,
                     f"C={C} channels exceed the kernel's shared-memory batch")
    num_tiles = starts.shape[0]
    out = torch.empty((num_tiles, C + 2, comp.TILE_PIX), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        _launch("probe_forward", "gsplat_probe_forward", v, table.data_ptr(),
                P, C, gauss_id.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), num_tiles, grid_x, TILE_X, TILE_Y,
                out.data_ptr(), _kernels.stream_of(table))
    return out


# ----------------------------------------------------------------- P2 ---

def probe_backward_plain(variant, table, gauss_id, starts, counts,
                         grid_x: int, packed, d_packed, Cg: int):
    """Plain version of P2's ``variant`` (``csrc/composite_bwd.cuh`` says
    what each removes): K2's per-instance rows [I, 6+Cg], walked like
    ``composite_cuda.composite_backward_plain``."""
    _variant(variant, BWD_VARIANTS)
    dev = table.device
    P, R = table.shape
    C = R - comp.ATTR_BASE
    I = gauss_id.shape[0]
    num_tiles = starts.shape[0]
    table_p = torch.cat([table, table.new_zeros((1, R))])    # sentinel row P
    out = torch.zeros((I, comp.ATTR_BASE + Cg), dtype=torch.float32,
                      device=dev)
    tb = max(1, (1 << 25) // (comp.CHUNK * comp.TILE_PIX))
    ks = torch.arange(comp.CHUNK, dtype=torch.int32, device=dev)
    for t0 in range(0, num_tiles, tb):
        t1 = min(num_tiles, t0 + tb)
        n = t1 - t0
        tiles = torch.arange(t0, t1, device=dev)
        px, py = comp.pixel_coords(tiles, grid_x)
        ox, oy, qx, qy = comp.tile_basis(tiles, grid_x)
        st, cnt = starts[t0:t1], counts[t0:t1]
        fwd, dpk = packed[t0:t1], d_packed[t0:t1]
        n_contrib = fwd[:, C + 1]                                # [n,PIX]
        d_out = dpk[:, :C]                                       # [n,C,PIX]
        bg_term = fwd[:, C] * dpk[:, C]          # T_final * dL/dT_final
        tot = torch.sum(fwd[:, :C] * d_out, dim=1)               # [n,PIX]
        Tc = torch.ones((n, comp.TILE_PIX), dtype=torch.float32, device=dev)
        Pc = torch.zeros((n, comp.TILE_PIX), dtype=torch.float32, device=dev)
        limit = min(int(n_contrib.max()), int(cnt.max())) if n else 0
        for c0 in range(0, limit, comp.CHUNK):
            pos = c0 + ks                                        # [K]
            rows, valid, idx = comp._instance_rows(table_p, gauss_id, st,
                                                   cnt, pos, P)  # [n,K,R]
            dx, dy, power, raw = comp.pair_terms(rows, px, py)
            gate = (valid[:, :, None]
                    & ((pos + 1)[None, :, None] <= n_contrib[:, None, :]))
            if variant == "no_alpha":
                raw = rows[:, :, 5, None].expand_as(dx)
            elif variant == "exp":
                raw = rows[:, :, 5, None] * torch.exp(power)
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            contrib = gate & (alpha >= ALPHA_MIN)
            if variant != "no_alpha":
                contrib = contrib & (power <= 0.0)
            a = torch.where(contrib, alpha, 0.0)
            T_run = torch.cumprod(torch.cat([Tc[:, None, :], 1.0 - a], dim=1),
                                  dim=1)
            T_excl = T_run[:, :-1]
            Tc = T_run[:, -1]
            w = a * T_excl
            g = rows[:, :, comp.ATTR_BASE, None] * d_out[:, None, 0]
            for c in range(1, C):
                g = g + rows[:, :, comp.ATTR_BASE + c, None] * d_out[:, None, c]
            pref = Pc[:, None, :] + torch.cumsum(w * g, dim=1)
            Pc = pref[:, -1]
            suffix = tot[:, None, :] - pref
            da = torch.where(
                contrib,
                T_excl * g - (suffix + bg_term[:, None, :]) / (1.0 - a), 0.0)
            dpow = torch.where(contrib & (raw < ALPHA_MAX), raw * da, 0.0)
            A, B, Cc, op = (rows[:, :, j] for j in range(2, 6))
            live = op > 0.0
            s0 = dpow.sum(-1)
            d_op = torch.where(live, s0 / torch.where(live, op, 1.0), 0.0)
            if variant == "no_moments":
                cols = [s0] * 5 + [d_op]
            elif variant == "moments_basis":
                M = [dpow.sum(-1), (dpow * qx).sum(-1), (dpow * qy).sum(-1),
                     (dpow * (qx * qx)).sum(-1), (dpow * (qy * qy)).sum(-1),
                     (dpow * (qx * qy)).sum(-1)]
                xr = rows[:, :, 0] - ox
                yr = rows[:, :, 1] - oy
                sx = xr * M[0] - M[1]
                sy = yr * M[0] - M[2]
                cols = [-(A * sx + B * sy), -(Cc * sy + B * sx),
                        -0.5 * (xr * xr * M[0] - 2.0 * xr * M[1] + M[3]),
                        -(xr * yr * M[0] - xr * M[2] - yr * M[1] + M[5]),
                        -0.5 * (yr * yr * M[0] - 2.0 * yr * M[2] + M[4]),
                        torch.where(live, M[0] / torch.where(live, op, 1.0),
                                    0.0)]
            else:
                dpx, dpy = dpow * dx, dpow * dy
                sx, sy = dpx.sum(-1), dpy.sum(-1)                # [n,K]
                sxx, sxy, syy = ((dpx * dx).sum(-1), (dpx * dy).sum(-1),
                                 (dpy * dy).sum(-1))
                cols = [-(A * sx + B * sy), -(Cc * sy + B * sx), -0.5 * sxx,
                        -sxy, -0.5 * syy, d_op]
            if variant == "no_dfeat":
                if Cg > 0:
                    cols += [w.sum(-1)] + [torch.zeros_like(s0)] * (Cg - 1)
            else:
                cols += [(w * d_out[:, None, c]).sum(-1) for c in range(Cg)]
            out[idx[valid]] = torch.stack(cols, dim=-1)[valid]
    return out


def probe_backward(variant, table, gauss_id, starts, counts, grid_x: int,
                   packed, d_packed, Cg: int):
    """P2 wrapper: ``variant`` of K2 on K2's inputs (``composite_cuda.
    composite_backward``'s), rows [I, 6+Cg] f32, zero where the walk does
    not reach."""
    v = _variant(variant, BWD_VARIANTS)
    comp._check_backward_inputs(table, gauss_id, starts, counts, grid_x,
                                packed, d_packed, Cg)
    dev = table.device
    if dev.type == "cpu":
        return probe_backward_plain(variant, table, gauss_id, starts, counts,
                                    grid_x, packed, d_packed, Cg)
    _kernels.require(dev.type == "cuda", f"unsupported device {dev}")
    _kernels.require(comp.TILE_PIX <= comp._MAX_THREADS
                     and comp.TILE_PIX % 32 == 0,
                     f"TILE_X*TILE_Y={comp.TILE_PIX} must be a multiple of 32 "
                     f"up to {comp._MAX_THREADS}")
    P, R = table.shape
    C = R - comp.ATTR_BASE
    num_tiles = starts.shape[0]
    d_inst = torch.zeros((gauss_id.shape[0], comp.ATTR_BASE + Cg),
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("probe_backward", "gsplat_probe_backward", v,
                table.data_ptr(), P, C, Cg, gauss_id.data_ptr(),
                starts.data_ptr(), counts.data_ptr(), num_tiles, grid_x,
                TILE_X, TILE_Y, packed.data_ptr(), d_packed.data_ptr(),
                d_inst.data_ptr(), _kernels.stream_of(table))
    return d_inst


# ----------------------------------------------------------------- P3 ---

def load_limits_shape(num_tiles: int):
    """The shape of P3's ``limits``: one count per CTA of K1's tile split
    (``composite_cuda.forward_ctas``)."""
    return (num_tiles, int(comp.forward_ctas().max()) + 1)


def _staged_sums(table, gauss_id, starts, counts, limits, tiles_per_cta):
    """load_only's output: per group of ``tiles_per_cta`` consecutive tiles,
    word p's sum over the group's batches (in order) of the staged float of
    its index, each tile cut to the ``limits`` of the CTA of K1's split that
    owns pixel p."""
    dev = table.device
    P, R = table.shape
    npix = comp.TILE_PIX
    num_tiles = starts.shape[0]
    batch = comp._KERNEL_BATCH
    table_p = torch.cat([table, table.new_zeros((1, R))])
    part = comp.forward_ctas().to(dev)                            # [npix]
    n = counts.long()[:, None].expand(load_limits_shape(num_tiles))
    if limits is not None:
        n = torch.minimum(limits.long(), n)
    n = n[:, part]                                                # [T,npix]
    n_cta = (num_tiles + tiles_per_cta - 1) // tiles_per_cta
    acc = torch.zeros((n_cta, npix), dtype=torch.float32, device=dev)
    lane = torch.arange(npix, device=dev)
    k, col = lane // R, lane % R                                  # [npix]
    cta = torch.arange(n_cta, device=dev)
    I = gauss_id.shape[0]
    for i in range(tiles_per_cta):
        t = cta * tiles_per_cta + i
        real = t < num_tiles
        tt = torch.where(real, t, 0)
        cnt = torch.where(real[:, None], n[tt], 0)                # [n_cta,npix]
        for b0 in range(0, int(cnt.max()) if n_cta else 0, batch):
            nb = torch.clamp(cnt - b0, 0, batch)                  # [n_cta,npix]
            on = lane[None] < nb * R                              # [n_cta,npix]
            slot = torch.clamp(starts.long()[tt][:, None] + b0 + k[None],
                               0, max(I - 1, 0))
            g = gauss_id.long()[slot]
            g = torch.where((g >= 0) & (g < P), g, P)
            vals = table_p[g, col[None].expand_as(g)]
            acc = acc + torch.where(on, vals, 0.0)
    return acc


def probe_load_plain(variant, table, gauss_id, starts, counts, grid_x: int,
                     limits=None):
    """Plain version of P3's tile variants (``csrc/probe_load.cu``)."""
    _variant(variant, LOAD_VARIANTS)
    if variant == "compute_resident":
        from gsplat_tpu_torch.tools.workload import resident_ids
        return comp.composite_forward_plain(
            table, resident_ids(gauss_id, starts, counts), starts, counts,
            grid_x)
    return _staged_sums(table, gauss_id, starts, counts, limits,
                        TILES_PER_CTA if variant == "load_only_4tiles" else 1)


def probe_load(variant, table, gauss_id, starts, counts, grid_x: int,
               limits=None):
    """P3 wrapper for ``load_only`` ([T, TILE_PIX]), ``load_only_4tiles``
    ([ceil(T/4), TILE_PIX]) and ``compute_resident`` (K1's [T, C+2,
    TILE_PIX]) on K1's inputs; ``limits`` [T, split] int32 (optional, the
    loads only; ``load_limits_shape``) cuts each of K1's CTAs of a tile to
    the instances it stages."""
    v = _variant(variant, LOAD_VARIANTS)
    comp._check_tile_inputs(table, gauss_id, starts, counts, grid_x)
    dev = table.device
    num_tiles = starts.shape[0]
    if limits is not None:
        shape = load_limits_shape(num_tiles)
        _kernels.require(
            limits.dtype == torch.int32 and tuple(limits.shape) == shape
            and limits.is_contiguous() and limits.device == dev,
            f"limits must be a contiguous int32 {list(shape)} on {dev}, got "
            f"{limits.dtype} {list(limits.shape)} on {limits.device}")
    if dev.type == "cpu":
        return probe_load_plain(variant, table, gauss_id, starts, counts,
                                grid_x, limits)
    _kernels.require(dev.type == "cuda", f"unsupported device {dev}")
    _kernels.require(comp.TILE_PIX <= comp._MAX_THREADS,
                     f"TILE_X*TILE_Y={comp.TILE_PIX} exceeds "
                     f"{comp._MAX_THREADS} threads")
    _kernels.require(variant != "compute_resident"
                     or comp.TILE_X % comp.PIX_PER_THREAD == 0,
                     f"compute_resident takes rows of a multiple of "
                     f"{comp.PIX_PER_THREAD} pixels, not TILE_X={comp.TILE_X}")
    P, R = table.shape
    C = R - comp.ATTR_BASE
    _kernels.require(comp._KERNEL_BATCH * (R + 1) * 4 <= comp._SMEM_LIMIT,
                     f"C={C} channels exceed the kernel's shared-memory batch")
    if variant == "compute_resident":
        shape = (num_tiles, C + 2, comp.TILE_PIX)
    else:
        per = TILES_PER_CTA if variant == "load_only_4tiles" else 1
        shape = ((num_tiles + per - 1) // per, comp.TILE_PIX)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("probe_load", "gsplat_probe_load", v, table.data_ptr(), P, C,
                gauss_id.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                None if limits is None else limits.data_ptr(), num_tiles,
                grid_x, TILE_X, TILE_Y, out.data_ptr(),
                _kernels.stream_of(table))
    return out


def probe_gather_plain(variant, src, ids=None):
    """``row_gather``: rows of the [P, R] ``src`` by ``ids`` [I], zero for
    an id outside [0, P); ``block_copy``: a copy of the [I, R] ``src``."""
    _variant(variant, GATHER_VARIANTS)
    if variant == "block_copy":
        return src.clone()
    P = src.shape[0]
    ok = (ids >= 0) & (ids < P)
    rows = src[torch.where(ok, ids, 0).long()]
    return torch.where(ok[:, None], rows, 0.0)


def probe_gather(variant, src, ids=None):
    """P3 wrapper for ``row_gather`` (``src`` [P, R] f32, ``ids`` [I] int32:
    out [I, R]) and ``block_copy`` (``src`` [I, R], no ids)."""
    v = _variant(variant, GATHER_VARIANTS)
    dev = src.device
    req = _kernels.require
    req(src.dtype == torch.float32 and src.dim() == 2 and src.is_contiguous(),
        f"src must be contiguous 2-D float32, got {src.dtype} "
        f"{tuple(src.shape)}")
    req((ids is not None) == (variant == "row_gather"),
        "row_gather takes ids, block_copy none")
    if ids is not None:
        _kernels.check_int32_vector("ids", ids, dev)
    if dev.type == "cpu":
        return probe_gather_plain(variant, src, ids)
    req(dev.type == "cuda", f"unsupported device {dev}")
    n = src.shape[0] if ids is None else ids.shape[0]
    out = torch.empty((n, src.shape[1]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("probe_load", "gsplat_probe_gather", _GATHER_BASE + v,
                src.data_ptr(), src.shape[0], src.shape[1],
                None if ids is None else ids.data_ptr(), n, out.data_ptr(),
                _kernels.stream_of(src))
    return out


# ----------------------------------------------------------------- P4 ---

def probe_dtype_plain(x, n_iters: int):
    """The op mix of ``tools/bench_vpu_dtype.py::kernel`` (:31-38) in the
    dtype of ``x`` (float32 or bfloat16), each operation rounded to it; in
    float32 the exponential is taken as K1 takes it, exp2(-p log2 e)."""
    log2e = torch.tensor(comp.LOG2E, dtype=x.dtype, device=x.device)
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    quarter = torch.tensor(0.25, dtype=x.dtype, device=x.device)
    decay = torch.tensor(0.9999, dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    for _ in range(n_iters):
        p = x * x * half + x * quarter
        g = (torch.exp2(-p * log2e) if x.dtype == torch.float32
             else torch.exp(-p))
        a = g * x + p * half
        acc = acc + a
        x = x * decay
    return acc


def probe_dtype(x, n_programs: int = 64, n_iters: int = 64):
    """P4 wrapper: the op mix over ``x`` (float32, or bfloat16 with an even
    number of elements, as packed pairs), run by ``n_programs`` copies of
    the grid; out has x's shape and dtype."""
    dev = x.device
    req = _kernels.require
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"x must be float32 or bfloat16, got {x.dtype}")
    req(x.is_contiguous(), "x must be contiguous")
    req(n_programs >= 1 and n_iters >= 0, "n_programs >= 1, n_iters >= 0")
    if dev.type == "cpu":
        return probe_dtype_plain(x, n_iters)
    req(dev.type == "cuda", f"unsupported device {dev}")
    bf16 = x.dtype == torch.bfloat16
    req(not bf16 or x.numel() % 2 == 0, "bf16 x needs an even element count")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        _launch("probe_dtype", "gsplat_probe_dtype", int(bf16), x.data_ptr(),
                x.numel(), n_programs, n_iters, out.data_ptr(),
                _kernels.stream_of(x))
    return out
