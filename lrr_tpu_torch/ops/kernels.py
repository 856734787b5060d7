"""The port's hand-written Hopper kernels and their plain versions.

  K1 `normal_equations_sym` — the summed weighted Gauss-Newton system of the
     affine ICP over both match directions, with the coordinate
     normalisation inside (replaces
     lrr_tpu/ops/pallas_kernels.py::normal_equations_pallas, the XLA form in
     lrr_tpu/estimation/icp.py::_normal_equations_packed and the elementwise
     work XLA fused around it); source csrc/normal_equations.cu.
  K2 `knn` — exact k-NN by squared L2 with a running top-k (replaces
     lrr_tpu/ops/pallas_kernels.py::knn_pallas); source csrc/knn.cu.
  K3 `pinv_hermitian_small` — the pseudo-inverse of a batch of symmetric
     n x n matrices, n <= 12, by float64 Jacobi with no host round trip (no
     Pallas counterpart: lrr_tpu leaves the ICP's solve to XLA's
     eigensolver inside its wave program); source csrc/pinv_sym.cu.
  K4 `voronoi_nearest` — stage 1's exact nearest-valid-feature index map
     (no Pallas counterpart: lrr_tpu builds it with XLA ops; its plain
     versions are ops/voronoi.py's exact builds); source csrc/voronoi.cu.
  K5 `sample_matches` — the ICP's match sampler, one direction of one
     iteration (no Pallas counterpart: lrr_tpu samples with XLA gathers; its
     plain version is estimation/icp.py::sample_matches_plain); source
     csrc/sample_matches.cu.

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  `LAUNCHES` counts kernel
launches (never plain-version calls) so a run can show that its path went
through the kernels; `K1_SHAPES` and `K2_SHAPES` log which shapes they were
launched at, `PINV_SHAPES` K3's, `VORONOI_SHAPES` K4's, `SAMPLE_SHAPES`
K5's.  These are Python counters: a replayed CUDA graph moves them through
`add_counts` (pipeline/wave_graph.py).
"""

from __future__ import annotations

import ctypes

import torch

from lrr_tpu_torch.ops import native

KMAX = 128  # largest k the k-NN kernel keeps (the TPU kernel's lane width)

LAUNCHES = {"normal_equations": 0, "knn": 0, "pinv_sym": 0, "voronoi": 0, "sample_matches": 0}
K1_SHAPES: dict[tuple[int, int, int], int] = {}  # (L, M_f, M_b) -> launches
K2_SHAPES: dict[tuple[int, int, int, int], int] = {}  # (Q, N, D, k) -> launches
PINV_SHAPES: dict[tuple[int, int], int] = {}  # (L, n) -> launches
VORONOI_SHAPES: dict[tuple[int, int, int, int], int] = {}  # (D, H, W, N) -> launches
SAMPLE_SHAPES: dict[tuple[int, int, str], int] = {}  # (L, m, "grid" | "map") -> launches
PINV_MAX_N = 12  # the largest matrix K3 takes


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for log in _counters()[1:]:
        log.clear()


def _counters() -> tuple[dict, ...]:
    return LAUNCHES, K1_SHAPES, K2_SHAPES, PINV_SHAPES, VORONOI_SHAPES, SAMPLE_SHAPES


def counts() -> tuple[dict, ...]:
    """A copy of every counter: (LAUNCHES, K1_SHAPES, K2_SHAPES, PINV_SHAPES,
    VORONOI_SHAPES, SAMPLE_SHAPES)."""
    return tuple(dict(c) for c in _counters())


def counts_since(before: tuple[dict, ...]) -> tuple[dict, ...]:
    """What every counter gained since `before` (a `counts()`)."""
    return tuple({k: v - b.get(k, 0) for k, v in now.items() if v != b.get(k, 0)}
                 for now, b in zip(counts(), before))


def add_counts(delta: tuple[dict, ...], times: int = 1) -> None:
    """Add `times` x a `counts_since` delta to the counters (a shape whose
    count comes to 0 leaves its log)."""
    for counter, d in zip(_counters(), delta):
        for k, v in d.items():
            counter[k] = counter.get(k, 0) + times * v
            if counter[k] == 0 and counter is not LAUNCHES:
                del counter[k]


def _check_cuda(name: str, dtype, device, *tensors, contiguous: bool = True) -> None:
    for t in tensors:
        if t.device != device or t.dtype != dtype or (contiguous and not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected {'contiguous ' if contiguous else ''}{dtype} tensors "
                f"on {device}, got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )


# ---------------------------------------------------------------------------
# K1: normal equations
# ---------------------------------------------------------------------------


def c1c2(tag: torch.Tensor):
    """P = c1*I + c2*d d^T coefficients from the hot-loop row tag (0 =
    invalid, 1 = corner, 2 = sheet, 3 = tube)."""
    is_sheet = ((tag > 1.5) & (tag < 2.5)).to(tag.dtype)
    is_tube = (tag > 2.5).to(tag.dtype)
    return 1.0 - is_sheet, is_sheet - is_tube


def normal_equations_plain(
    center: torch.Tensor,  # [L, 3]
    fxyz: torch.Tensor,  # [L, 3, M]
    txyz: torch.Tensor,  # [L, 3, M]
    pdir: torch.Tensor,  # [L, 3, M]
    c1: torch.Tensor,  # [L, M]
    c2: torch.Tensor,  # [L, M]
    w: torch.Tensor,  # [L, M]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction, already normalised: AtA [L, 12, 12], Atb [L, 12] as
    G^T G and G^T y with G[(i, m), 4k+l] = sqrt(w_m) P_m[i, k] h_m[l] (the
    JAX package's `_normal_equations_packed`, batched over lanes)."""
    L, _, M = fxyz.shape
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    xc = fxyz - center[:, :, None]
    h = torch.cat([xc, torch.ones_like(xc[:, :1])], dim=1)  # [L, 4, M]
    swc1 = sw * c1
    swd = (sw * c2)[:, None, :] * pdir  # [L, 3, M]
    swP = [
        [swd[:, r] * pdir[:, c] + (swc1 if r == c else 0.0) for c in range(3)]
        for r in range(3)
    ]
    # G[l, 4c+d, r, m]
    G = torch.stack(
        [
            torch.stack([swP[r][c] * h[:, d] for r in range(3)], dim=1)
            for c in range(3)
            for d in range(4)
        ],
        dim=1,
    ).reshape(L, 12, 3 * M)
    y = (sw[:, None, :] * txyz).reshape(L, 3 * M)
    AtA = torch.einsum("lnj,lpj->lnp", G, G)
    Atb = torch.einsum("lnj,lj->ln", G, y)
    return AtA, Atb


# One direction's matches for K1: (from-points [L, 3, M], to-points
# [L, 3, M], projector direction [L, 3, M], tag [L, M], weight [L, M]).
Direction = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def normal_equations_sym_plain(
    fwd: Direction,
    bwd: Direction,
    cm: torch.Tensor,  # [L, 3] center of the from-side (moving) frame
    cf: torch.Tensor,  # [L, 3] center of the to-side (fixed) frame
    rm: torch.Tensor,  # [L] radius of the from-side frame
    rf: torch.Tensor,  # [L] radius of the to-side frame
    center: torch.Tensor,  # [L, 3] the normalised transform's center
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch composition of K1: per direction normalise the points
    ((x - c) / r), take (c1, c2) from the tag, form the system
    (`normal_equations_plain`), then add the two directions."""
    total = None
    for from_xyz, to_xyz, pdir, tag, w in (fwd, bwd):
        from_n = (from_xyz - cm[:, :, None]) / rm[:, None, None]
        to_n = (to_xyz - cf[:, :, None]) / rf[:, None, None]
        c1, c2 = c1c2(tag)
        part = normal_equations_plain(center, from_n, to_n, pdir, c1, c2, w)
        total = part if total is None else (total[0] + part[0], total[1] + part[1])
    return total


def normal_equations_sym(
    fwd: Direction,
    bwd: Direction,
    cm: torch.Tensor,
    cf: torch.Tensor,
    rm: torch.Tensor,
    rf: torch.Tensor,
    center: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1.  Arguments as `normal_equations_sym_plain`, float32 throughout;
    the two directions may hold different match counts.  The per-match
    tensors may be strided views (the ICP's row gathers are read in place);
    the frame tensors must be contiguous.  Returns AtA [L, 12, 12] (full,
    symmetric) and Atb [L, 12]."""
    dev = cm.device
    if dev.type == "cpu":
        return normal_equations_sym_plain(fwd, bwd, cm, cf, rm, rf, center)
    if dev.type != "cuda":
        raise ValueError(f"normal_equations_sym: unsupported device {dev}")
    L = cm.shape[0]
    for t, shape in ((cm, (L, 3)), (cf, (L, 3)), (center, (L, 3)), (rm, (L,)), (rf, (L,))):
        if t.shape != shape:
            raise ValueError(f"normal_equations_sym: frame shape {tuple(t.shape)}, want {shape}")
    _check_cuda("normal_equations_sym", torch.float32, dev, cm, cf, rm, rf, center)
    pointers, strides, counts = [], [], []
    for direction in (fwd, bwd):
        if len(direction) != 5:
            raise ValueError("normal_equations_sym: a direction is (from, to, dir, tag, w)")
        M = direction[4].shape[-1]
        for t in direction[:3]:
            if t.shape != (L, 3, M):
                raise ValueError(f"normal_equations_sym: shape {tuple(t.shape)}, want {(L, 3, M)}")
        for t in direction[3:]:
            if t.shape != (L, M):
                raise ValueError(f"normal_equations_sym: shape {tuple(t.shape)}, want {(L, M)}")
        _check_cuda("normal_equations_sym", torch.float32, dev, *direction, contiguous=False)
        pointers += [t.data_ptr() for t in direction]
        strides += [s for t in direction for s in t.stride()]
        counts.append(M)
    AtA = torch.empty((L, 12, 12), dtype=torch.float32, device=dev)
    Atb = torch.empty((L, 12), dtype=torch.float32, device=dev)
    if L > 0:
        pointers += [t.data_ptr() for t in (cm, cf, rm, rf, center, AtA, Atb)]
        native.check(
            native.library().lrr_normal_equations_sym(
                (ctypes.c_void_p * 17)(*pointers), (ctypes.c_longlong * 26)(*strides),
                L, counts[0], counts[1], torch.cuda.current_stream(dev).cuda_stream,
            ),
            "normal_equations_sym",
        )
        LAUNCHES["normal_equations"] += 1
        shape = (L, counts[0], counts[1])
        K1_SHAPES[shape] = K1_SHAPES.get(shape, 0) + 1
    return AtA, Atb


# ---------------------------------------------------------------------------
# K2: k-NN
# ---------------------------------------------------------------------------


def knn_plain(
    queries: torch.Tensor,  # [Q, D]
    points: torch.Tensor,  # [N, D]
    mask: torch.Tensor,  # [N] bool
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d2 [Q, k], idx [Q, k] int32) by direct sum_c (q_c - p_c)^2, summed
    in component order with every step rounded to fp32 (the kernel's exact
    arithmetic); ties go to the lower index (stable sort)."""
    Q, D = queries.shape
    N = points.shape[0]
    d2 = queries.new_zeros((Q, N))
    for c in range(D):
        diff = queries[:, c, None] - points[None, :, c]
        d2 = d2 + diff * diff
    d2 = torch.where(mask[None, :], d2, torch.full_like(d2, float("inf")))
    vals, idx = torch.sort(d2, dim=1, stable=True)
    if N < k:  # fewer points than k: pad with the +inf / unspecified tail
        vals = torch.cat([vals, vals.new_full((Q, k - N), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_full((Q, k - N), -1)], 1)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may take on sm_90
_WIDE_MIN_TILES = 64  # 64 x 64 tiles from which K2 takes its wide tile shape


def knn_plan(Q: int, N: int, D: int, k: int, device) -> tuple[int, int]:
    """(wide, splits) for K2: wide 64 x 64 tiles from `_WIDE_MIN_TILES` full
    ones on (where the two shapes were measured to cross, 512 x 512 on an
    H100), else narrow 16 x 16 ones; then as many point splits as keep one
    wave of resident blocks (never more than there are point tiles)."""
    lib = native.library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wide = int((Q // 64) * (N // 64) >= _WIDE_MIN_TILES)
    if wide and lib.lrr_knn_smem_bytes(D, k, 1) > _SMEM_LIMIT:
        wide = 0
    smem = lib.lrr_knn_smem_bytes(D, k, wide)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"knn: D={D}, k={k} too wide for the shared-memory tiles")
    tile, threads = (64, 256) if wide else (16, 128)
    resident = sms * max(1, min(_SMEM_LIMIT // smem, 2048 // threads, 32))
    q_tiles, p_tiles = -(-Q // tile), max(1, -(-N // tile))
    splits = max(1, min(p_tiles, resident // q_tiles))
    per_split = -(-p_tiles // splits)
    return wide, -(-p_tiles // per_split)


def knn(
    queries: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2.  Exact k-NN (1 <= k <= 128); masked points never match."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"knn: k={k} outside [1, {KMAX}]")
    if queries.device.type == "cpu":
        return knn_plain(queries, points, mask, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {queries.device}")
    Q, D = queries.shape
    N = points.shape[0]
    if points.shape != (N, D) or mask.shape != (N,):
        raise ValueError(f"knn: bad shapes {queries.shape} {points.shape} {mask.shape}")
    dev = queries.device
    _check_cuda("knn", torch.float32, dev, queries, points)
    _check_cuda("knn", torch.bool, dev, mask)
    d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q > 0:
        wide, splits = knn_plan(Q, N, D, k, dev)
        # the splits' lists, merged by the kernel's second pass
        part_d = torch.empty((Q, splits, k), dtype=torch.float32, device=dev) if splits > 1 else d
        part_i = torch.empty((Q, splits, k), dtype=torch.int32, device=dev) if splits > 1 else i
        native.check(
            native.library().lrr_knn(
                queries.data_ptr(), points.data_ptr(), mask.data_ptr(),
                d.data_ptr(), i.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
                Q, N, D, k, wide, splits, torch.cuda.current_stream(dev).cuda_stream,
            ),
            "knn",
        )
        LAUNCHES["knn"] += 1
        K2_SHAPES[(Q, N, D, k)] = K2_SHAPES.get((Q, N, D, k), 0) + 1
    return d, i


# ---------------------------------------------------------------------------
# K3: small symmetric pseudo-inverse
# ---------------------------------------------------------------------------


def pinv_hermitian_plain(a: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.pinv(a, hermitian=True)`: cut at rcond = 10 * max(M, N) *
    eps of the largest |eigenvalue| (torch's default rtol is 10x smaller).
    A matrix with a non-finite entry gives all-NaN, as in JAX, without
    reaching the eigensolver (which may raise on it where JAX does not)."""
    rtol = 10 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    finite = torch.isfinite(a).flatten(-2).all(-1)[..., None, None]
    out = torch.linalg.pinv(
        torch.where(finite, a, torch.zeros_like(a)), hermitian=True, rtol=rtol
    )
    return torch.where(finite, out, torch.full_like(out, torch.nan))


def pinv_hermitian_small(a: torch.Tensor, rotations: torch.Tensor | None = None) -> torch.Tensor:
    """K3.  `pinv_hermitian_plain` of float32 [..., n, n], n <= 12, reading
    the lower triangle; the Jacobi sweeps run in float64 and the result is
    rounded once.  With `rotations` (int32, one entry a matrix) the kernel
    also writes how many rotations each matrix took (for the bound)."""
    if a.device.type == "cpu":
        return pinv_hermitian_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"pinv_hermitian_small: unsupported device {a.device}")
    n = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != n or not 1 <= n <= PINV_MAX_N:
        raise ValueError(f"pinv_hermitian_small: shape {tuple(a.shape)}, want [..., n, n], "
                         f"n <= {PINV_MAX_N}")
    flat = a.reshape(-1, n, n).contiguous()
    L = flat.shape[0]
    _check_cuda("pinv_hermitian_small", torch.float32, a.device, flat)
    out = torch.empty_like(flat)
    if rotations is not None:
        _check_cuda("pinv_hermitian_small", torch.int32, a.device, rotations)
        if rotations.shape != (L,):
            raise ValueError(f"pinv_hermitian_small: rotations {tuple(rotations.shape)}, want {(L,)}")
    if L > 0:
        rtol = 10 * n * torch.finfo(torch.float32).eps
        native.check(
            native.library().lrr_pinv_sym(
                flat.data_ptr(), out.data_ptr(), 0 if rotations is None else rotations.data_ptr(),
                L, n, rtol, torch.cuda.current_stream(a.device).cuda_stream,
            ),
            "pinv_hermitian_small",
        )
        LAUNCHES["pinv_sym"] += 1
        PINV_SHAPES[(L, n)] = PINV_SHAPES.get((L, n), 0) + 1
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# K4: the exact Voronoi map
# ---------------------------------------------------------------------------


def voronoi_nearest(
    xyz: torch.Tensor,  # [N, 3] feature locations (physical)
    mask: torch.Tensor,  # [N] bool
    origin: torch.Tensor,  # [3] (x, y, z) of voxel (0, 0, 0)
    spacing: torch.Tensor,  # [3]
    shape_zyx: tuple[int, int, int],
    stats: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4.  The exact nearest-valid-feature index map int32 [D, H, W] (-1
    where no feature is valid), with the bits of `voronoi_map_exact` (and
    of `voronoi_map_exact_blocked`, which gives the same).  On the CPU the
    plain build by size (`voronoi.voronoi_map_exact_plain`).  On the card
    every tensor is contiguous float32 (the mask bool) and origin and
    spacing are read there, with no host read.  With `stats` (int64 [2],
    zeroed) the kernel adds the voxel-candidate pairs it evaluated and the
    candidates its blocks kept (for the bound)."""
    if xyz.device.type == "cpu":
        from lrr_tpu_torch.ops import voronoi

        return voronoi.voronoi_map_exact_plain(xyz, mask, origin, spacing, shape_zyx)
    if xyz.device.type != "cuda":
        raise ValueError(f"voronoi_nearest: unsupported device {xyz.device}")
    N = xyz.shape[0]
    D, H, W = (int(s) for s in shape_zyx)
    if xyz.shape != (N, 3) or mask.shape != (N,) or origin.shape != (3,) or spacing.shape != (3,):
        raise ValueError(f"voronoi_nearest: bad shapes {tuple(xyz.shape)} {tuple(mask.shape)} "
                         f"{tuple(origin.shape)} {tuple(spacing.shape)}")
    if min(D, H, W) < 1:
        raise ValueError(f"voronoi_nearest: empty map {shape_zyx}")
    dev = xyz.device
    _check_cuda("voronoi_nearest", torch.float32, dev, xyz, origin, spacing)
    _check_cuda("voronoi_nearest", torch.bool, dev, mask)
    if stats is not None:
        _check_cuda("voronoi_nearest", torch.int64, dev, stats)
        if stats.shape != (2,):
            raise ValueError(f"voronoi_nearest: stats {tuple(stats.shape)}, want (2,)")
    out = torch.empty((D, H, W), dtype=torch.int32, device=dev)
    packed = torch.empty((max(N, 1), 4), dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    native.check(
        native.library().lrr_voronoi_nearest(
            xyz.data_ptr(), mask.data_ptr(), origin.data_ptr(), spacing.data_ptr(),
            packed.data_ptr(), count.data_ptr(), out.data_ptr(),
            0 if stats is None else stats.data_ptr(), N, D, H, W,
            torch.cuda.current_stream(dev).cuda_stream,
        ),
        "voronoi_nearest",
    )
    LAUNCHES["voronoi"] += 1
    shape = (D, H, W, N)
    VORONOI_SHAPES[shape] = VORONOI_SHAPES.get(shape, 0) + 1
    return out


# ---------------------------------------------------------------------------
# K5: the ICP's match sampler
# ---------------------------------------------------------------------------


def sample_matches(src, grid, vor, trans, number, cap: int, offset, *, dst_rows, p0: int,
                   m: int):
    """K5.  Window positions [p0, p0 + m) of each lane's cyclic window of
    capacity `cap` over its permutation `src.order` (from `offset`), the
    source rows `src.rows` under `src.lane_mask`, mapped through `trans`
    (an `Affine3D` of L lanes) into `vor`'s map and matched by the target
    row there: `grid`'s, or without a grid `dst_rows`' row of the voxel's
    feature in `vor.index_vol`.  Returns (src [L, m, 8], dst [L, m, 8],
    weight [L, m], mask [L, m]) as `icp.sample_matches_plain`, its plain
    version, which the CPU takes.  On the card every tensor is contiguous:
    order, valid count, offset and number int64, the masks bool, the map
    int32, everything else float32, with no host read."""
    dev = src.order.device
    if dev.type == "cpu":
        from lrr_tpu_torch.estimation import icp

        return icp.sample_matches_plain(src, grid, vor, trans, number, cap, offset,
                                        dst_rows=dst_rows, p0=p0, m=m)
    if dev.type != "cuda":
        raise ValueError(f"sample_matches: unsupported device {dev}")
    L, cols = src.order.shape
    D, H, W = (int(n) for n in vor.index_vol.shape)
    shapes = ((src.lane_mask, (L, src.lane_mask.shape[1])), (src.valid_count, (L,)),
              (offset, (L,)), (number, (L,)), (trans.A, (L, 3, 3)), (trans.t, (L, 3)),
              (trans.center, (L, 3)), (vor.origin, (3,)), (vor.spacing, (3,)),
              (src.rows, (src.rows.shape[0], 8)))
    if grid is not None:
        shapes += ((grid, (D * H * W, 8)),)
    elif dst_rows is None:
        raise ValueError("sample_matches: without a grid the target rows are needed")
    else:
        shapes += ((dst_rows, (dst_rows.shape[0], 8)),)
    for t, shape in shapes:
        if t.dim() != len(shape) or tuple(t.shape) != shape:
            raise ValueError(f"sample_matches: shape {tuple(t.shape)}, want {shape}")
    if not (0 <= p0 and 0 <= m and 0 <= cap <= cols and L <= 65535):
        raise ValueError(f"sample_matches: window p0={p0}, m={m}, cap={cap} of {cols}, L={L}")
    _check_cuda("sample_matches", torch.int64, dev, src.order, src.valid_count, offset, number)
    _check_cuda("sample_matches", torch.bool, dev, src.lane_mask)
    _check_cuda("sample_matches", torch.int32, dev, vor.index_vol)
    _check_cuda("sample_matches", torch.float32, dev, src.rows, trans.A, trans.t,
                trans.center, vor.origin, vor.spacing,
                *((grid,) if grid is not None else (dst_rows,)))
    for t in (src.rows, grid if grid is not None else dst_rows):
        if t.data_ptr() % 16:
            raise ValueError("sample_matches: row tables must be 16-byte aligned")
    rows = torch.empty((2, L, m, 8), dtype=torch.float32, device=dev)
    weight = torch.empty((L, m), dtype=torch.float32, device=dev)
    mask = torch.empty((L, m), dtype=torch.bool, device=dev)
    if L > 0 and m > 0:
        native.check(
            native.library().lrr_sample_matches(
                src.order.data_ptr(), src.rows.data_ptr(), src.lane_mask.data_ptr(),
                src.valid_count.data_ptr(), offset.data_ptr(), number.data_ptr(),
                trans.A.data_ptr(), trans.t.data_ptr(), trans.center.data_ptr(),
                vor.origin.data_ptr(), vor.spacing.data_ptr(),
                None if grid is None else grid.data_ptr(), vor.index_vol.data_ptr(),
                None if dst_rows is None else dst_rows.data_ptr(), rows[0].data_ptr(),
                rows[1].data_ptr(), weight.data_ptr(), mask.data_ptr(), cols,
                src.lane_mask.shape[1], L, m, p0, cap, D, H, W,
                torch.cuda.current_stream(dev).cuda_stream,
            ),
            "sample_matches",
        )
        LAUNCHES["sample_matches"] += 1
        shape = (L, m, "map" if grid is None else "grid")
        SAMPLE_SHAPES[shape] = SAMPLE_SHAPES.get(shape, 0) + 1
    return rows[0], rows[1], weight, mask
