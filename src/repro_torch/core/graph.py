"""CSR graph container and builders.

The host-side ``Graph`` (numpy) is the preprocessing-time representation:
TOCAB is a *static* blocking scheme, so partitioning happens before any
iteration runs, exactly as in the paper.  ``DeviceGraph`` is the flat
edge-centric (COO + CSR) representation on the card for the *baseline*
(non-blocked) engines; the blocked representation lives in
:mod:`repro_torch.core.partition`.

The generators give the reference package's graphs array for array (same
seeds, same numpy random streams).  The heavy passes (dedup sort, CSR
build, R-MAT bit assembly) run as multi-threaded torch CPU ops, and the
R-MAT generator draws its uniform stream in parallel slices of one PCG64
sequence (``PCG64.advance``), so the Graph500-scale graphs the chip run uses
are built in a fraction of the single-threaded numpy time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.trace import span

__all__ = [
    "Graph",
    "DeviceGraph",
    "GraphValidationError",
    "from_edges",
    "validate_graph",
    "graph_fingerprint",
    "device_graph_from_arrays",
    "rmat_graph",
    "uniform_random_graph",
    "grid_graph",
]

#: cap on how many colidx entries the fingerprint hashes (strided sample)
_FP_SAMPLE = 4096

#: cap on how many colidx entries level="cheap" bounds-checks (strided sample)
_VALIDATE_SAMPLE = 65536

_INT32_MAX = np.iinfo(np.int32).max


class GraphValidationError(ValueError):
    """A CSR structural invariant does not hold.

    ``check`` names the violated invariant (stable identifier, e.g.
    ``"rowptr_monotone"``), ``detail`` is a human-readable description."""

    def __init__(self, check: str, detail: str):
        super().__init__(f"{check}: {detail}")
        self.check = check
        self.detail = detail


def validate_graph(g: "Graph", level: str = "cheap") -> "Graph":
    """Check CSR invariants, raising :class:`GraphValidationError`.

    ``level="cheap"`` is O(n) + an O(sample) colidx bounds check: rowptr
    shape/endpoints/monotonicity, strided colidx sample in ``[0, n)``,
    edge-value length, and int32 addressability (the device engines index
    with int32).  ``level="full"`` additionally bounds-checks every colidx
    entry.  Returns ``g`` unchanged on success so calls can be chained."""
    if level not in ("cheap", "full"):
        raise ValueError(f"unknown validation level {level!r}")
    n, rowptr, colidx = g.n, np.asarray(g.rowptr), np.asarray(g.colidx)
    m = int(colidx.shape[0])
    if n < 0:
        raise GraphValidationError("n_negative", f"n={n} < 0")
    if n > _INT32_MAX or m > _INT32_MAX:
        raise GraphValidationError(
            "budget_overflow",
            f"n={n}, m={m} exceed int32 addressing used by device engines")
    if rowptr.ndim != 1 or rowptr.shape[0] != n + 1:
        raise GraphValidationError(
            "rowptr_shape",
            f"rowptr has shape {rowptr.shape}, expected ({n + 1},)")
    if m and not np.issubdtype(rowptr.dtype, np.integer):
        raise GraphValidationError(
            "rowptr_dtype", f"rowptr dtype {rowptr.dtype} is not integral")
    if int(rowptr[0]) != 0:
        raise GraphValidationError(
            "rowptr_origin", f"rowptr[0]={int(rowptr[0])}, expected 0")
    if int(rowptr[-1]) != m:
        raise GraphValidationError(
            "rowptr_total",
            f"rowptr[-1]={int(rowptr[-1])} != m={m} (len(colidx))")
    if n and np.any(np.diff(rowptr) < 0):
        bad = int(np.argmax(np.diff(rowptr) < 0))
        raise GraphValidationError(
            "rowptr_monotone",
            f"rowptr decreases at row {bad} "
            f"({int(rowptr[bad])} -> {int(rowptr[bad + 1])})")
    if g.vals is not None and np.asarray(g.vals).shape[0] != m:
        raise GraphValidationError(
            "vals_length",
            f"vals has {np.asarray(g.vals).shape[0]} entries, expected m={m}")
    if m:
        sample = colidx
        if level == "cheap" and m > _VALIDATE_SAMPLE:
            sample = colidx[:: max(1, m // _VALIDATE_SAMPLE)]
        lo, hi = int(sample.min()), int(sample.max())
        if lo < 0 or hi >= n:
            raise GraphValidationError(
                "colidx_range",
                f"colidx entries span [{lo}, {hi}], expected [0, {n})")
    return g


def _fingerprint_arrays(n: int, m: int, out_degree, colidx) -> str:
    """Canonical structural fingerprint (the tuning-db key of the reference).

    Hashes (n, m, the full out-degree sequence, a strided colidx sample) —
    the same string ``repro.core.graph.graph_fingerprint`` gives for the
    same graph, independent of edge weights, stable across processes."""
    h = hashlib.sha256()
    h.update(f"repro.graph/v1:{n}:{m}:".encode())
    h.update(np.ascontiguousarray(out_degree, dtype=np.int64).tobytes())
    colidx = np.ascontiguousarray(colidx, dtype=np.int32)
    stride = max(1, colidx.shape[0] // _FP_SAMPLE)
    h.update(colidx[::stride].tobytes())
    return h.hexdigest()[:16]


def graph_fingerprint(g) -> str:
    """Fingerprint of a :class:`Graph` or :class:`DeviceGraph` (see
    :func:`_fingerprint_arrays`).  DeviceGraphs built via ``from_host``
    carry it precomputed; hand-built ones are hashed on the fly."""
    fp = getattr(g, "fingerprint", None)
    if isinstance(fp, str):
        return fp
    if isinstance(g, Graph):
        return _fingerprint_arrays(g.n, g.m, g.out_degree, g.colidx)
    return _fingerprint_arrays(
        g.n, g.m, g.out_degree.cpu().numpy(), g.dst.cpu().numpy())


@dataclasses.dataclass(frozen=True)
class Graph:
    """Host-side CSR graph (out-edges).  ``vals`` optional per-edge weights."""

    n: int
    rowptr: np.ndarray  # int64[n+1]
    colidx: np.ndarray  # int32[m]
    vals: Optional[np.ndarray] = None  # float32[m]

    @property
    def m(self) -> int:
        return int(self.colidx.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.rowptr).astype(np.int32)

    @property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.colidx, minlength=self.n).astype(np.int32)

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """COO view: (src, dst) arrays, src-sorted."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.out_degree)
        return src, self.colidx.astype(np.int32)

    def transpose(self) -> "Graph":
        """Gᵀ — used to derive pull (in-edge) iteration and push blocking."""
        src, dst = self.edges()
        return from_edges(self.n, dst, src, vals=self.vals)

    def average_degree(self) -> float:
        return self.m / max(self.n, 1)

    def degree_histogram(self, bounds=(8, 16, 32)) -> dict:
        """Degree distribution buckets — reproduces paper Table 1."""
        deg = self.out_degree
        hist, lo = {}, 0
        for b in bounds:
            hist[f"{lo}~{b - 1}"] = float(np.mean((deg >= lo) & (deg < b)))
            lo = b
        hist[f"{lo}~"] = float(np.mean(deg >= lo))
        return hist

    def validate(self, level: str = "cheap") -> "Graph":
        """Check CSR invariants (see :func:`validate_graph`)."""
        return validate_graph(self, level=level)


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Flat edge-centric representation for the baseline engines: int32
    index tensors on one device."""

    n: int
    src: torch.Tensor  # int32[m]  (src-sorted)
    dst: torch.Tensor  # int32[m]
    rowptr: torch.Tensor  # int32[n+1]
    out_degree: torch.Tensor  # int32[n]
    in_degree: torch.Tensor  # int32[n]
    vals: Optional[torch.Tensor] = None  # float32[m]
    fingerprint: Optional[str] = None

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    @classmethod
    def from_host(cls, g: Graph, device="cuda") -> "DeviceGraph":
        """Ship ``g`` to ``device`` (the card unless the caller names
        another).  The COO source column is expanded on the device.
        Traced, a ``graph.from_host`` span."""
        with span("graph.from_host", device=device, n=g.n, m=g.m):
            rowptr = torch.from_numpy(
                np.ascontiguousarray(g.rowptr, np.int64)).to(device)
            out_degree = (rowptr[1:] - rowptr[:-1]).to(torch.int32)
            dst = torch.from_numpy(
                np.ascontiguousarray(g.colidx, np.int32)).to(device)
            src = torch.repeat_interleave(
                torch.arange(g.n, dtype=torch.int32, device=dst.device),
                out_degree.long(), output_size=g.m)
            in_degree = torch.bincount(dst, minlength=g.n).to(torch.int32)
            vals = None
            if g.vals is not None:
                vals = torch.from_numpy(
                    np.ascontiguousarray(g.vals, np.float32)).to(device)
            return cls(n=g.n, src=src, dst=dst,
                       rowptr=rowptr.to(torch.int32), out_degree=out_degree,
                       in_degree=in_degree, vals=vals,
                       fingerprint=graph_fingerprint(g))


def device_graph_from_arrays(arrays: dict, meta: dict,
                             device="cuda") -> DeviceGraph:
    """Build a :class:`DeviceGraph` from numpy arrays named like its fields
    (``src, dst, rowptr, out_degree, in_degree`` and optionally ``vals``)
    and ``meta`` (``n`` and optionally ``fingerprint``) — e.g. the fields of
    a reference ``repro.core.DeviceGraph`` — so both packages can run on
    one identical graph."""
    def put(name, dtype):
        a = arrays.get(name)
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return DeviceGraph(
        n=int(meta["n"]),
        src=put("src", np.int32), dst=put("dst", np.int32),
        rowptr=put("rowptr", np.int32),
        out_degree=put("out_degree", np.int32),
        in_degree=put("in_degree", np.int32),
        vals=put("vals", np.float32),
        fingerprint=meta.get("fingerprint"))


def _csr_from_coo(n: int, src: torch.Tensor, dst: torch.Tensor,
                  vals: Optional[np.ndarray], dedup: bool) -> Graph:
    """CSR from int64 CPU COO tensors, equal array for array to the
    reference's numpy build: dedup keeps the *first* occurrence of each
    (src, dst) pair (``np.unique(..., return_index=True)``), then edges are
    stably sorted by source (``np.argsort(kind="stable")``)."""
    if dedup and src.numel():
        keys, order = torch.sort(src * n + dst, stable=True)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        del keys
        idx = order[first]
        del order, first
        src, dst = src[idx], dst[idx]
        if vals is not None:
            vals = np.asarray(vals)[idx.numpy()]
    if src.numel() > 1 and not bool((src[1:] >= src[:-1]).all()):
        order = torch.sort(src, stable=True).indices
        src, dst = src[order], dst[order]
        if vals is not None:
            vals = np.asarray(vals, dtype=np.float32)[order.numpy()]
    if vals is not None:
        vals = np.ascontiguousarray(vals, dtype=np.float32)
    rowptr = torch.zeros(n + 1, dtype=torch.int64)
    rowptr[1:] = torch.bincount(src, minlength=n)
    rowptr = torch.cumsum(rowptr, 0)
    return Graph(n=n, rowptr=rowptr.numpy(),
                 colidx=dst.to(torch.int32).numpy(), vals=vals)


def from_edges(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    vals: Optional[np.ndarray] = None,
    dedup: bool = False,
    validate: Optional[str] = None,
) -> Graph:
    """Build a CSR :class:`Graph` from COO edges.

    Endpoints outside ``[0, n)`` raise :class:`GraphValidationError`
    (``"coo_range"``) whatever ``validate`` says; ``validate="cheap"`` /
    ``"full"`` also runs :func:`validate_graph` on the result."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise GraphValidationError(
            "coo_shape", f"src shape {src.shape} != dst shape {dst.shape}")
    if src.size:
        lo = min(int(src.min()), int(dst.min()))
        hi = max(int(src.max()), int(dst.max()))
        if lo < 0 or hi >= n:
            raise GraphValidationError(
                "coo_range",
                f"edge endpoints span [{lo}, {hi}], expected [0, {n})")
    g = _csr_from_coo(n, torch.from_numpy(np.ascontiguousarray(src)),
                      torch.from_numpy(np.ascontiguousarray(dst)), vals,
                      dedup)
    return g if validate is None else validate_graph(g, level=validate)


#: edges per task of the parallel R-MAT generator (a cache-sized slice)
_RMAT_CHUNK = 1 << 16


def _rmat_chunk(state: dict, m: int, scale: int, a: float, b: float,
                c: float, lo: int, hi: int, perm: np.ndarray):
    """Endpoints ``lo:hi`` of the R-MAT edge list, permuted, self-loops
    dropped.  Level ``lvl`` of the reference draws ``rng.random(m)``; a
    float64 uniform consumes exactly one 64-bit PCG64 output, so this slice
    of that draw is a copy of the generator advanced by ``lvl*m + lo``.
    numpy runs the fills and ufuncs without the GIL, so chunks run on all
    cores."""
    k = hi - lo
    r = np.empty(k, dtype=np.float64)
    ge = np.empty(k, dtype=bool)
    quad = np.empty(k, dtype=np.uint8)
    bit = np.empty(k, dtype=np.int64)
    src = np.zeros(k, dtype=np.int64)
    dst = np.zeros(k, dtype=np.int64)
    bitgen = np.random.PCG64()
    # Every ufunc writes into the buffers above: per-call temporaries would
    # serialise the threads on the allocator.
    for lvl in range(scale):
        bitgen.state = state
        bitgen.advance(lvl * m + lo)
        np.random.Generator(bitgen).random(out=r)
        # quadrant of the reference's intervals [0,a) [a,a+c) [a+c,a+b+c)
        # [a+b+c,1) as 0..3: bit 0 is its go_down (src high bit), bit 1
        # its go_right (dst high bit) — the same comparisons, counted
        np.greater_equal(r, a, out=ge)
        np.copyto(quad, ge)
        np.greater_equal(r, a + c, out=ge)
        np.add(quad, ge, out=quad)
        np.greater_equal(r, a + b + c, out=ge)
        np.add(quad, ge, out=quad)
        np.bitwise_and(quad, 1, out=bit)
        np.left_shift(bit, lvl, out=bit)
        np.bitwise_or(src, bit, out=src)
        np.right_shift(quad, 1, out=bit)
        np.left_shift(bit, lvl, out=bit)
        np.bitwise_or(dst, bit, out=dst)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    return src[keep], dst[keep]


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    undirected: bool = False,
    weights: bool = False,
) -> Graph:
    """R-MAT/Kronecker power-law generator (Graph500-style: the defaults
    ``a, b, c = .57, .19, .19`` are the Graph500 generator's) — scale-free
    graphs like the paper's Kron21/Twitter suite.  Equal to
    ``repro.core.rmat_graph`` for the same arguments."""
    rng = np.random.default_rng(seed)
    if not isinstance(rng.bit_generator, np.random.PCG64):
        raise TypeError("rmat_graph relies on numpy's default PCG64 stream")
    n = 1 << scale
    m = n * edge_factor
    state = rng.bit_generator.state
    rng.bit_generator.advance(scale * m)  # past the scale levels' draws
    # permute vertex ids to kill the locality R-MAT bakes in (paper targets
    # graphs with *poor* layouts)
    perm = rng.permutation(n)
    workers = max(1, min(os.cpu_count() or 1, 32))
    with ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(
            lambda lo: _rmat_chunk(state, m, scale, a, b, c, lo,
                                   min(lo + _RMAT_CHUNK, m), perm),
            range(0, m, _RMAT_CHUNK)))
    src = torch.from_numpy(np.concatenate([p[0] for p in parts]))
    dst = torch.from_numpy(np.concatenate([p[1] for p in parts]))
    del parts
    if undirected:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    vals = rng.random(src.shape[0], dtype=np.float32) if weights else None
    return _csr_from_coo(n, src, dst, vals, dedup=True)


def uniform_random_graph(
    n: int, m: int, seed: int = 0, weights: bool = False
) -> Graph:
    """Erdős–Rényi-ish uniform random digraph."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    vals = rng.random(int(keep.sum()), dtype=np.float32) if weights else None
    return from_edges(n, src[keep], dst[keep], vals=vals, dedup=True)


def grid_graph(rows: int, cols: int) -> Graph:
    """2D grid digraph (right+down edges) — a *good-locality* graph, the
    Hollywood-analogue control for the paper's claim that GraphCage causes
    only trivial slowdown on graphs that already have good layouts."""
    n = rows * cols
    ids = np.arange(n).reshape(rows, cols)
    src = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    dst = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    return from_edges(n, src, dst)
