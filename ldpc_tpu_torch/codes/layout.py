"""Layout compiler: LDPCCode -> gather/scatter-friendly array layouts.

The reference walks linked adjacency lists sequentially (BASELINE.json:5 'the
sequential message-passing loop'); on TPU the decoder instead consumes dense,
statically-shaped index tensors (BASELINE.json:5 'H-matrix storage becomes a
gather/scatter-friendly edge-index layout'). This module compiles an LDPCCode
into:

  * flat edge arrays (edge_vn, edge_cn), edges ordered by (check, variable) —
    the universal layout for the jnp reference decoder;
  * dense padded per-check / per-variable edge-index tables for gather-based
    flooding updates;
  * a per-layer QC view (base columns + circulant shifts per base row) for the
    layered Pallas kernel, where one layer's Z checks are processed as a unit
    and each variable is touched at most once per layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .code import LDPCCode


@dataclass(frozen=True)
class EdgeLayout:
    """Flat + padded-dense edge indexing for an LDPC code.

    Edges are numbered 0..E-1 in (check, variable) sort order, so each check's
    edges are a contiguous range.

    cn_edges[c, t] = edge index of check c's t-th neighbor, or E (sentinel) when
    t >= deg(c). Buffers indexed by edge are padded to length E+1 so the
    sentinel gathers a neutral value. Same scheme for vn_edges.
    """

    n: int
    m: int
    E: int
    edge_vn: np.ndarray  # (E,) int32
    edge_cn: np.ndarray  # (E,) int32
    cn_edges: np.ndarray  # (m, max_dc) int32, pad = E
    cn_mask: np.ndarray  # (m, max_dc) bool
    vn_edges: np.ndarray  # (n, max_dv) int32, pad = E
    vn_mask: np.ndarray  # (n, max_dv) bool
    max_dc: int
    max_dv: int
    # Dense cn-major views for the gather-only jnp decoder: messages live in a
    # flat (m*max_dc + 1) buffer whose last slot is a zero dump/pad slot.
    ev_dense: np.ndarray = None  # (m, max_dc) int32: variable per slot, pad = n
    vn_pos: np.ndarray = None  # (n, max_dv) int32: flat cn-major position of
    #   each variable's edges, pad = m*max_dc (the dump slot)
    edge_pos: np.ndarray = None  # (E,) int32: flat cn-major position of edge e


def compile_edge_layout(code: LDPCCode) -> EdgeLayout:
    edge_vn_l, edge_cn_l = [], []
    for c, vs in enumerate(code.cn_adj):
        vs = np.sort(np.asarray(vs, np.int64))
        edge_vn_l.append(vs)
        edge_cn_l.append(np.full(len(vs), c, np.int64))
    edge_vn = np.concatenate(edge_vn_l).astype(np.int32)
    edge_cn = np.concatenate(edge_cn_l).astype(np.int32)
    E = len(edge_vn)

    degs_c = np.array([len(v) for v in code.cn_adj], np.int64)
    max_dc = int(degs_c.max())
    cn_edges = np.full((code.m, max_dc), E, np.int32)
    cn_mask = np.zeros((code.m, max_dc), bool)
    starts = np.concatenate([[0], np.cumsum(degs_c)])
    for c in range(code.m):
        d = int(degs_c[c])
        cn_edges[c, :d] = np.arange(starts[c], starts[c] + d, dtype=np.int32)
        cn_mask[c, :d] = True

    vn_lists: list[list[int]] = [[] for _ in range(code.n)]
    for e in range(E):
        vn_lists[int(edge_vn[e])].append(e)
    max_dv = max((len(l) for l in vn_lists), default=0)
    vn_edges = np.full((code.n, max_dv), E, np.int32)
    vn_mask = np.zeros((code.n, max_dv), bool)
    for v, l in enumerate(vn_lists):
        vn_edges[v, : len(l)] = l
        vn_mask[v, : len(l)] = True

    # Dense cn-major views. Edge e sits at flat position
    # edge_cn[e]*max_dc + slot(e), slot = e - first edge of its check.
    edge_slot = np.concatenate(
        [np.arange(int(d), dtype=np.int64) for d in degs_c]
    ) if E else np.zeros(0, np.int64)
    edge_pos = (edge_cn.astype(np.int64) * max_dc + edge_slot).astype(np.int32)
    ev_dense = np.full((code.m, max_dc), code.n, np.int32)
    ev_dense[cn_mask] = edge_vn
    dump = code.m * max_dc
    vn_pos = np.full((code.n, max_dv), dump, np.int32)
    vn_pos[vn_mask] = edge_pos[vn_edges[vn_mask]]

    return EdgeLayout(
        n=code.n, m=code.m, E=E, edge_vn=edge_vn, edge_cn=edge_cn,
        cn_edges=cn_edges, cn_mask=cn_mask, vn_edges=vn_edges, vn_mask=vn_mask,
        max_dc=max_dc, max_dv=max_dv,
        ev_dense=ev_dense, vn_pos=vn_pos, edge_pos=edge_pos,
    )


@dataclass(frozen=True)
class QCLayout:
    """Per-layer QC view for layered decoding.

    Layer i = base row i = Z parallel checks. Entry t of layer i touches base
    column layer_cols[i, t] with circulant shift layer_shifts[i, t]; check r of
    the layer connects to variable layer_cols[i,t]*Z + (r + shift) % Z.
    Padding: layer_cols = -1, layer_shifts = 0, layer_mask = False.

    Guarantee (asserted): within one layer every variable appears at most once,
    so the layer's Z checks can update posteriors with disjoint writes
    (SURVEY.md §5.2).
    """

    Z: int
    mb: int
    nb: int
    max_row_deg: int
    layer_cols: np.ndarray  # (mb, max_row_deg) int32
    layer_shifts: np.ndarray  # (mb, max_row_deg) int32
    layer_mask: np.ndarray  # (mb, max_row_deg) bool


def compile_qc_layout(code: LDPCCode) -> QCLayout:
    if code.base is None or code.Z is None:
        raise ValueError(f"code {code.name} has no QC structure")
    base, Z = code.base, int(code.Z)
    mb, nb = base.shape
    row_deg = (base >= 0).sum(axis=1)
    max_row_deg = int(row_deg.max())
    layer_cols = np.full((mb, max_row_deg), -1, np.int32)
    layer_shifts = np.zeros((mb, max_row_deg), np.int32)
    layer_mask = np.zeros((mb, max_row_deg), bool)
    for i in range(mb):
        cols = np.nonzero(base[i] >= 0)[0]
        assert len(set(cols.tolist())) == len(cols)  # disjoint columns per layer
        layer_cols[i, : len(cols)] = cols
        layer_shifts[i, : len(cols)] = base[i, cols]
        layer_mask[i, : len(cols)] = True
    return QCLayout(Z=Z, mb=mb, nb=nb, max_row_deg=max_row_deg,
                    layer_cols=layer_cols, layer_shifts=layer_shifts,
                    layer_mask=layer_mask)


def compile_layers_general(code: LDPCCode) -> list[np.ndarray]:
    """Greedy grouping of checks into layers with pairwise-disjoint variable
    sets, for layered decoding of non-QC codes. Returns list of check-index
    arrays. QC codes should use compile_qc_layout instead."""
    layers: list[list[int]] = []
    layer_vars: list[set] = []
    for c, vs in enumerate(code.cn_adj):
        vset = set(int(v) for v in vs)
        placed = False
        for li in range(len(layers)):
            if not (layer_vars[li] & vset):
                layers[li].append(c)
                layer_vars[li] |= vset
                placed = True
                break
        if not placed:
            layers.append([c])
            layer_vars.append(vset)
    return [np.asarray(l, np.int32) for l in layers]
