"""Network-level layout assignment (paper §IV.D) and fused-op planning
(``repro/core/selector.py``), priced by a ``CostModel`` on a device
profile.

The paper scans the network once, sets a per-layer layout field from the
heuristic, and inserts a transform wherever consecutive layers disagree,
using one-time profiling to confirm the transform overhead is amortized.
``assign_layouts`` implements that arbitration as a shortest-path dynamic
program over per-layer layout states: node cost = layer cost under a
layout (the cost model's), edge cost = the transform between consecutive
layers' layouts.  ``paper_heuristic_layouts`` is the single-scan rule
itself.

``plan_fused`` extends the DP for the fused engine: an edge costs nothing
when the re-layout folds into the producing kernel's output write or the
consuming conv's input read, and conv->relu->pool runs collapse into
single ``FusedOp`` nodes priced by the fusion cost model.  With
``stack_policy="auto"`` adjacent conv groups pair into two-conv stack nodes
where the device profile's stack gate admits them and the recomputed halo
costs less than the mid activation's round trip saves.

Layers are a DAG: a ``LayerDesc`` may name explicit producer ``inputs``
(-1 is the network input; empty means "the previous layer").  Branching
networks (``add``, ``concat``, ``upsample``) take frontier DPs whose state
is the (layout, dtype) of every live edge; a residual add whose operands
qualify folds into the producing conv's epilogue.  A linear graph takes
the chain code path.

With ``dtype_policy="mixed"`` both DPs search per-layer (layout, storage
dtype) states: interior conv chains may store int8 where both casts fold
(``plan_fused``), or pay standalone cast passes (``assign_layouts``, which
therefore never picks int8).  The port's executors run uniform plans; int8
boundaries raise there.

Every expression keeps the reference's operation order, so under a
profile built from the reference's constants the two packages' plans are
equal field for field (``total_s`` floats included); the port's default
profile is the H100's (``perfmodel.hardware``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.paper_table1 import ConvLayer, PoolLayer
from repro_torch.core.layout import transform_bytes
from repro_torch.dtypes import (INT8_DTYPE, canon_dtype,
                                dtype_bytes as _dtype_bytes)
from repro_torch.perfmodel import (CostModel, DEFAULT_DTYPE_BYTES, Hardware,
                                   Thresholds, default_cost_model,
                                   default_hardware, select_conv_layout,
                                   select_pool_layout)
from repro_torch.shapes import pool_out_hw

LAYOUTS = ("CHWN", "NCHW")
DTYPE_POLICIES = ("uniform", "mixed")

# reverse map for labeling plans built from bare LayerDescs (which carry
# only an element size); ambiguity at 2 bytes resolves to bf16, as the
# reference resolves it
_BYTES_TO_NAME = {4: "float32", 2: "bfloat16", 1: "int8"}


def _base_dtype_name(layers: Sequence["LayerDesc"],
                     base_dtype: Optional[str]) -> str:
    if base_dtype is not None:
        return canon_dtype(base_dtype)
    db = layers[0].dtype_bytes if layers else 4
    return _BYTES_TO_NAME.get(db, "float32")


@dataclass
class LayerDesc:
    """One network layer as seen by the selector."""
    name: str
    kind: str                       # conv | pool | act | fc | softmax |
                                    # flatten | add | concat | upsample
    conv: Optional[ConvLayer] = None
    pool: Optional[PoolLayer] = None
    out_shape: Tuple[int, ...] = ()   # logical NCHW shape of the output
    dtype_bytes: int = DEFAULT_DTYPE_BYTES   # storage element size
    trainable: bool = True          # False: frozen params, wgrad skipped
    # Graph edges: indices of the producer layers this layer consumes (-1 is
    # the network input).  Empty = "the previous layer" — the linear default,
    # under which both DPs take the original chain code path unchanged.
    inputs: Tuple[int, ...] = ()


def _resolved_inputs(layers: Sequence[LayerDesc]) -> List[Tuple[int, ...]]:
    """Per-layer producer indices with the linear default filled in."""
    rins: List[Tuple[int, ...]] = []
    for i, l in enumerate(layers):
        ins = tuple(l.inputs) if l.inputs else ((i - 1,) if i else (-1,))
        for p in ins:
            if p >= i or p < -1:
                raise ValueError(
                    f"layer {l.name!r}: input index {p} is not an earlier "
                    f"layer (layers must be topologically ordered)")
        rins.append(ins)
    return rins


def _is_linear(rins: Sequence[Tuple[int, ...]]) -> bool:
    return all(ins == ((i - 1,) if i else (-1,))
               for i, ins in enumerate(rins))


def _consumers(rins: Sequence[Tuple[int, ...]]) -> Dict[int, List[int]]:
    cons: Dict[int, List[int]] = {i: [] for i in range(-1, len(rins))}
    for i, ins in enumerate(rins):
        for p in ins:
            cons[p].append(i)
    return cons


def _pool_io_bytes(l: LayerDesc) -> Tuple[int, int]:
    p = l.pool
    ho = pool_out_hw(p.HW, p.F, p.S)   # shared with the pool kernels
    d = l.dtype_bytes
    return p.N * p.C * p.HW * p.HW * d, p.N * p.C * ho * ho * d


def _merge_io_bytes(l: LayerDesc, training: bool) -> int:
    """Modeled HBM bytes of a STANDALONE merge/branch layer.  ``add`` reads
    both operands and writes the sum (its backward is a pure gradient
    fan-out — routing, not traffic); ``concat``/``upsample`` stream read +
    write forward and again for the backward slice/reduction."""
    sz = int(np.prod(l.out_shape)) if l.out_shape else 0
    if l.kind == "add":
        return 3 * sz * l.dtype_bytes
    if l.kind in ("concat", "upsample"):
        return (4 if training else 2) * sz * l.dtype_bytes
    raise ValueError(l.kind)


def layer_cost(l: LayerDesc, layout: str, training: bool = False,
               cost_model: Optional[CostModel] = None) -> float:
    """Estimated seconds for this layer in this layout (forward, plus the
    backward direction when ``training``)."""
    cm = cost_model or default_cost_model()
    if l.kind == "conv" and l.conv is not None:
        t = cm.conv_cost(l.conv, layout, l.dtype_bytes).total_s
        if training:
            t += cm.conv_backward_cost(l.conv, layout, l.dtype_bytes,
                                       fused=False).total_s
        return t
    if l.kind == "pool" and l.pool is not None:
        # memory bound: bytes / bw, de-rated by tile utilization of the
        # layout's minormost dims (paper Fig. 6: NCHW pooling is strided)
        in_b, out_b = _pool_io_bytes(l)
        eff = 1.0 if layout == "CHWN" else 0.25   # strided window penalty
        bytes_ = in_b + out_b
        if training:                 # bwd: read g + read input (mask) + write
            bytes_ += 2 * in_b + out_b
        return bytes_ / (cm.hw.mem_bw * eff)
    if l.kind == "act":
        n = float(np.prod(l.out_shape)) if l.out_shape else 0.0
        b = (5 if training else 2) * n * l.dtype_bytes
        return b / cm.hw.mem_bw
    if l.kind in ("fc", "softmax", "flatten"):
        return 0.0     # layout-terminal (2-D)
    if l.kind in ("add", "concat", "upsample"):
        # merge/branch nodes are memory bound in either layout (elementwise /
        # channel-stack / nearest-neighbour expand all stream contiguously)
        return _merge_io_bytes(l, training) / cm.hw.mem_bw
    # Anything else (lrn, or a conv/pool desc missing its descriptor) has no
    # executor behind it — cnn.network raises at run time, so refusing to
    # plan it here keeps planner and executor in agreement.
    raise ValueError(
        f"layer {l.name!r}: kind {l.kind!r} is not executable by the "
        "CNN engines; refusing to produce a plan the executor would reject")


def transform_cost(shape: Tuple[int, ...], dtype_bytes: int,
                   optimized: bool = True,
                   hw: Optional[Hardware] = None) -> float:
    """Seconds to re-layout a tensor of ``shape`` on ``hw`` (the default
    profile unless given); the optimized transform runs at ~streaming
    bandwidth (paper Fig. 11: up to 97.6% of peak), the naive one at ~1/8
    of it."""
    eff = 0.9 if optimized else 0.12
    hw = hw or default_hardware()
    return transform_bytes(shape, dtype_bytes) / (hw.mem_bw * eff)


@dataclass
class Assignment:
    layouts: List[str]
    transforms: List[int]           # i where a transform precedes layer i
    total_s: float
    dtypes: List[str] = field(default_factory=list)  # per-layer storage dtype


def assign_layouts(layers: Sequence[LayerDesc], *,
                   input_layout: str = "NCHW",
                   input_shape: Optional[Tuple[int, ...]] = None,
                   optimized_transform: bool = True,
                   training: bool = False,
                   measure: Optional[Callable[[LayerDesc, str], float]] = None,
                   thresholds: Optional[Thresholds] = None,
                   dtype_policy: str = "uniform",
                   base_dtype: Optional[str] = None,
                   cost_model: Optional[CostModel] = None) -> Assignment:
    """Shortest-path over (layer, layout) states (the UNFUSED engine's plan;
    ``plan_fused`` is the variant whose edges fold into kernel I/O maps).

    ``input_shape`` is the logical NCHW shape of the *network input* — the
    tensor transformed by an i == 0 layout change (which generally differs
    from ``layers[0].out_shape``).  ``training`` plans the whole training
    graph: node costs include the backward direction and every transform
    edge is paid twice (the activation re-layout forward, its reversed twin
    on the gradient coming back).

    ``dtype_policy="mixed"`` widens the state space to (layout, storage
    dtype): a conv layer's output may be stored int8, but the unfused engine
    has no epilogue to fold the casts into, so quantize costs a standalone
    pass on the edge leaving the node and dequantize another on the edge
    into the consumer (``cast_cost``).  Both are strictly positive on top of
    the uniform path, so this DP degenerates to the uniform assignment — the
    search is kept because proving that is the point (mixed dtypes pay only
    under fusion).
    """
    if dtype_policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype_policy {dtype_policy!r}; "
                         f"known: {DTYPE_POLICIES}")
    cm = cost_model or default_cost_model()
    cost_fn = measure or (lambda l, lay: layer_cost(l, lay, training, cm))
    n = len(layers)
    INF = float("inf")
    in_shape = tuple(input_shape) if input_shape else (
        layers[0].out_shape if layers else ())
    base = _base_dtype_name(layers, base_dtype)
    base_db = layers[0].dtype_bytes if layers else _dtype_bytes(base)
    rins = _resolved_inputs(layers)
    if not _is_linear(rins):
        return _assign_layouts_graph(
            layers, rins, input_layout=input_layout, in_shape=in_shape,
            optimized_transform=optimized_transform, training=training,
            cost_fn=cost_fn, dtype_policy=dtype_policy, base=base,
            base_db=base_db, cm=cm)
    tx = 2 if training else 1        # gradients re-cross every edge

    def cands(i: int) -> Tuple[str, ...]:
        # conv outputs may store int8 (unfused: never pays, but searched);
        # the last layer's output is the network result — keep it base
        if (dtype_policy == "mixed" and i + 1 < n
                and layers[i].kind == "conv"):
            return (base, INT8_DTYPE)
        return (base,)

    # dp[(layout, dtype)] = (cost, path of (layout, dtype)); start in the
    # input layout/base dtype only — the i == 0 edge below prices any
    # immediate re-layout of the network input
    State = Tuple[str, str]
    dp: Dict[State, Tuple[float, List[State]]] = {
        (lay, base): ((0.0 if lay == input_layout else INF), [(lay, base)])
        for lay in LAYOUTS}
    for i, l in enumerate(layers):
        ndp: Dict[State, Tuple[float, List[State]]] = {}
        for lay in LAYOUTS:
            for dt in cands(i):
                best, path = INF, None
                for (prev, prev_dt), (c0, p0) in dp.items():
                    edge = 0.0
                    # the layer input (= previous layer's output; the
                    # network input when i == 0)
                    shape = layers[i - 1].out_shape if i else in_shape
                    if prev_dt != base:     # dequant pass before compute
                        edge += tx * cm.cast_cost(shape,
                                                  _dtype_bytes(prev_dt),
                                                  base_db)
                    if prev != lay:
                        edge += tx * transform_cost(shape,
                                                    _dtype_bytes(prev_dt),
                                                    optimized_transform,
                                                    hw=cm.hw)
                    if dt != base:          # quant pass after compute
                        edge += tx * cm.cast_cost(l.out_shape, base_db,
                                                  _dtype_bytes(dt))
                    c = c0 + edge + cost_fn(l, lay)
                    if c < best:
                        best, path = c, p0 + [(lay, dt)]
                ndp[(lay, dt)] = (best, path)
        dp = ndp
    st_best = min(dp, key=lambda k: dp[k][0])
    total, path = dp[st_best]
    layouts = [st[0] for st in path[1:]]
    dtypes = [st[1] for st in path[1:]]
    transforms = [i for i in range(n)
                  if (layouts[i] != (layouts[i - 1] if i else input_layout))]
    return Assignment(layouts=layouts, transforms=transforms, total_s=total,
                      dtypes=dtypes)


def paper_heuristic_layouts(layers: Sequence[LayerDesc],
                            th: Thresholds) -> List[str]:
    """The paper's §IV.D single-scan field assignment (no DP)."""
    out = []
    cur = "NCHW"
    for l in layers:
        if l.kind == "conv" and l.conv is not None:
            cur = select_conv_layout(l.conv, th)
        elif l.kind == "pool":
            cur = select_pool_layout(l.pool)
        out.append(cur)    # act/fc/softmax inherit the incoming layout
    return out


# ---------------------------------------------------------------------------
# fused-op planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedOp:
    """One node of the fused execution plan.

    ``layout`` is the layout the kernel computes in; ``src_layout`` /
    ``dst_layout`` are the layouts it consumes/produces (folded re-layouts
    when they differ from ``layout``).  For conv nodes, ``relu`` and
    ``pool_index`` mark the folded epilogue layers.  ``src_dtype`` /
    ``dst_dtype`` are the STORAGE dtypes of the tensors the node reads /
    writes in HBM (mixed-dtype plans store interior activations as int8:
    the epilogue quantizes, the consumer conv dequantizes on chip).  Empty
    string means "the run's dtype" — plans persisted without dtypes load
    with that value and behave exactly as before.
    """
    kind: str                       # conv | pool | act | fc | softmax |
                                    # flatten | add | concat | upsample
    index: int                      # primary layer index in the LayerDesc list
    name: str
    layout: str
    src_layout: str
    dst_layout: str
    relu: bool = False
    pool_index: Optional[int] = None
    src_dtype: str = ""
    dst_dtype: str = ""
    # Graph fields.  Defaults keep pre-DAG persisted plans
    # loading unchanged through ``FusedOp(**op)``.
    inputs: Tuple[int, ...] = ()    # producer layer indices (main input first)
    out_index: int = -1             # layer index whose output this op stores
    add_index: Optional[int] = None   # residual-add layer folded into this op
    res_index: Optional[int] = None   # producer of the folded skip tensor
    res_layout: str = ""            # stored layout of the folded skip tensor
    # Cross-layer stack fusion.  A conv op with
    # ``stack_index`` set runs TWO convs in one kernel: ``index`` is the
    # first conv, ``stack_index`` the second; ``stack_relu`` is the act
    # folded between them, and relu/pool_index/add_index/res_index describe
    # the SECOND conv's epilogue.  The intermediate activation never touches
    # HBM.  Defaults keep pre-stack persisted plans loading unchanged.
    stack_index: Optional[int] = None
    stack_relu: bool = False

    def __post_init__(self):
        # JSON roundtrips tuples as lists; normalize so loaded plans compare
        # equal to freshly planned ones
        if not isinstance(self.inputs, tuple):
            object.__setattr__(self, "inputs", tuple(self.inputs))

    @property
    def is_fused(self) -> bool:
        return (self.relu or self.pool_index is not None or
                self.res_index is not None or
                self.stack_index is not None or
                self.src_layout != self.layout or
                self.dst_layout != self.layout)


# one-letter storage-dtype codes for plan signatures (reports/benchmarks)
DTYPE_CODES = {"float32": "f", "bfloat16": "b", "float16": "h", "int8": "8",
               "": "?"}


@dataclass
class FusedPlan:
    layouts: List[str]              # per-layer layout (DP assignment)
    ops: List[FusedOp]              # execution nodes, in order
    transforms: List[int]           # layer indices needing a STANDALONE pass
    total_s: float                  # modeled seconds under the fused engine
    fused_bytes: int                # modeled HBM bytes, fused engine
    unfused_bytes: int              # same layouts executed unfused
    dtypes: List[str] = field(default_factory=list)  # per-layer storage dtype
    base_dtype: str = ""            # the float dtype non-int8 layers run in
    # bytes still round-tripping through the mid activation of adjacent,
    # structurally stackable conv pairs the planner did NOT fuse: zero when
    # every such pair either fused or was legitimately ineligible (stack
    # gate, recompute arbitration, overlap with a fused stack)
    intermediate_roundtrip_bytes: int = 0

    @property
    def saved_bytes(self) -> int:
        return self.unfused_bytes - self.fused_bytes

    @property
    def conv_signature(self) -> str:
        """One letter per conv LAYER ('C'HWN / 'N'CHW) — the compact form the
        serving report and benchmarks use to show batch-dependent flips.  A
        stack op covers two conv layers in one kernel and contributes two
        (identical) letters, so the signature length is stable across
        stacking decisions."""
        return "".join(op.layout[0] * (2 if op.stack_index is not None else 1)
                       for op in self.ops if op.kind == "conv")

    @property
    def dtype_signature(self) -> str:
        """One letter per conv LAYER's OUTPUT storage dtype (f/b/h/8) — shows
        where the mixed DP placed the int8 layers.  A stack op's first conv
        never stores its output (that is the point); it reports the op's
        stored dtype so the signature length matches ``conv_signature``."""
        return "".join(DTYPE_CODES.get(op.dst_dtype, "?")
                       * (2 if op.stack_index is not None else 1)
                       for op in self.ops if op.kind == "conv")

    @property
    def stacked_convs(self) -> int:
        """Conv->conv stacks fused into single kernels."""
        return sum(1 for op in self.ops
                   if op.kind == "conv" and op.stack_index is not None)

    @property
    def distinct_conv_dtypes(self) -> int:
        return len({op.dst_dtype for op in self.ops if op.kind == "conv"})

    @property
    def standalone_adds(self) -> int:
        """Residual adds the planner could NOT fold into a conv epilogue —
        the headline metric of DAG fusion (resnet18 plans at zero)."""
        return sum(1 for op in self.ops if op.kind == "add")


def _dst_layout(layers: Sequence[LayerDesc], layouts: Sequence[str],
                j: int, lay: str) -> str:
    """Layout a producer should write: the consumer's layout, or NCHW ahead
    of flatten/fc so the 2-D flatten is a free reshape."""
    if j >= len(layers):
        return lay
    if layers[j].kind in ("flatten", "fc", "softmax"):
        return "NCHW"
    return layouts[j]


@dataclass(frozen=True)
class _Group:
    """A fused-op DP node: a conv[->act][->pool] chain, a lone pool, or a
    passthrough layer.  The whole group executes in ONE layout (one kernel
    for conv chains), which is what makes its intermediates free."""
    start: int
    end: int                        # exclusive
    kind: str                       # chain head kind
    relu: bool = False
    pool_index: Optional[int] = None
    add_index: Optional[int] = None   # residual add folded into a conv group
    res_src: Optional[int] = None     # producer layer index of the skip tensor
    # Cross-layer stack pairing: a conv group absorbing a
    # SECOND conv group.  ``stack_index`` is the second conv's head layer,
    # ``stack_relu`` the act folded between the convs; relu/pool_index/
    # add_index/res_src above then describe the second conv's epilogue.
    stack_index: Optional[int] = None
    stack_relu: bool = False


def _pool_folds(layers: Sequence[LayerDesc], i: int, j: int,
                cm: CostModel) -> bool:
    """Whether conv ``i`` may fold pool ``j``: some layout's engine can run
    the chain in one launch (the profile's gate; always on the
    reference's)."""
    p = layers[j].pool
    return any(cm.chain_fits(layers[i].conv, lay, (p.F, p.S))
               for lay in LAYOUTS)


def _group_layers(layers: Sequence[LayerDesc],
                  cm: CostModel) -> List[_Group]:
    groups: List[_Group] = []
    n = len(layers)
    flat = False
    i = 0
    while i < n:
        l = layers[i]
        if l.kind == "conv" and l.conv is not None and not flat:
            relu = False
            pool_idx = None
            j = i + 1
            if j < n and layers[j].kind == "act":
                relu = True          # elementwise: folds in any layout
                j += 1
            if (j < n and layers[j].kind == "pool"
                    and layers[j].pool is not None
                    and _pool_folds(layers, i, j, cm)):
                pool_idx = j
                j += 1
            groups.append(_Group(i, j, "conv", relu, pool_idx))
            i = j
            continue
        if l.kind == "flatten":
            flat = True
        groups.append(_Group(i, i + 1, l.kind))
        i += 1
    return groups


def _group_layers_graph(layers: Sequence[LayerDesc],
                        rins: Sequence[Tuple[int, ...]],
                        cons: Dict[int, List[int]],
                        cm: CostModel) -> List[_Group]:
    """Graph grouping: a conv folds [->add][->act][->pool] when each folded
    layer is the SOLE consumer of its in-group predecessor — the group's
    interior tensors are then never needed elsewhere, which is exactly the
    condition under which they may skip HBM.  A corollary the DP relies on:
    every cross-group edge references a group TAIL (an interior layer with
    an external consumer would have blocked the fold that made it interior).
    On a linear graph this reproduces ``_group_layers`` exactly."""
    groups: List[_Group] = []
    n = len(layers)
    flat = False
    i = 0
    while i < n:
        l = layers[i]
        if l.kind == "conv" and l.conv is not None and not flat:
            relu = False
            pool_idx = None
            add_idx = None
            res_src = None
            j = i + 1
            if (j < n and layers[j].kind == "add" and cons[j - 1] == [j]
                    and (j - 1) in rins[j] and len(rins[j]) == 2):
                add_idx = j          # residual add -> conv epilogue
                res_src = next(p for p in rins[j] if p != j - 1)
                j += 1
            if (j < n and layers[j].kind == "act" and cons[j - 1] == [j]
                    and rins[j] == (j - 1,)):
                relu = True          # elementwise: folds in any layout
                j += 1
            if (j < n and layers[j].kind == "pool"
                    and layers[j].pool is not None and cons[j - 1] == [j]
                    and rins[j] == (j - 1,)
                    and _pool_folds(layers, i, j, cm)):
                pool_idx = j
                j += 1
            groups.append(_Group(i, j, "conv", relu, pool_idx,
                                 add_index=add_idx, res_src=res_src))
            i = j
            continue
        if l.kind == "flatten":
            flat = True
        groups.append(_Group(i, i + 1, l.kind))
        i += 1
    return groups


def _group_pool(layers: Sequence[LayerDesc],
                g: _Group) -> Optional[Tuple[int, int]]:
    if g.pool_index is None:
        return None
    p = layers[g.pool_index].pool
    return (p.F, p.S)


# ---------------------------------------------------------------------------
# cross-layer stack pairing
# ---------------------------------------------------------------------------

def _stackable_pair(layers: Sequence[LayerDesc], g1: _Group, g2: _Group,
                    rins: Sequence[Tuple[int, ...]],
                    cons: Dict[int, List[int]]) -> bool:
    """Structural predicate: (g1, g2) may run as one halo-fused stack kernel.
    g1 must be a bare conv[->act] group (no pool — the spatial decimation
    would break the halo arithmetic — and no folded residual), its tail must
    be the SOLE consumer edge into g2's MAIN conv input, and the geometry
    must chain (g2 reads exactly g1's output).  g2 keeps its full epilogue
    (add/act/pool) — the stack kernel runs it on the staged tile."""
    if g1.kind != "conv" or g2.kind != "conv":
        return False
    if g1.stack_index is not None or g2.stack_index is not None:
        return False
    l1, l2 = layers[g1.start].conv, layers[g2.start].conv
    if l1 is None or l2 is None:
        return False
    if g1.pool_index is not None or g1.add_index is not None:
        return False
    t1 = g1.end - 1
    if g2.start != g1.end:           # must be list-adjacent (topo order)
        return False
    if rins[g2.start] != (t1,) or cons[t1] != [g2.start]:
        return False
    return (l2.HW == l1.out_hw and l2.Ci == l1.Co and l2.N == l1.N)


def _stack_layouts(layers: Sequence[LayerDesc], g1: _Group, g2: _Group,
                   cm: CostModel) -> Tuple[str, ...]:
    """Layouts in which fusing (g1, g2) is both legal and profitable.

    Legal: the profile's stack gate admits it (``stack_nt`` > 0).
    Profitable: the recomputed halo rows cost less time than the mid
    activation's round trip saves — Δcompute <= Δmemory on the roofline
    components — AND the stack moves strictly fewer HBM bytes than the two
    groups do separately.  This is the recompute-vs-round-trip arbitration
    the stack cost model exists for; an empty result means "do not pair"
    and the plan degenerates to the unstacked shape byte for byte.
    """
    l1, l2 = layers[g1.start].conv, layers[g2.start].conv
    db = layers[g1.start].dtype_bytes
    pool_t = _group_pool(layers, g2)
    res = g2.add_index is not None
    b_stack = cm.stack_bytes(l1, l2, db, pool=pool_t, residual=res)
    b_pair = (cm.chain_bytes(l1, db, relu=g1.relu, fused=True) +
              cm.chain_bytes(l2, db, relu=g2.relu, pool=pool_t, fused=True,
                             residual=res))
    if b_stack >= b_pair:
        return ()
    out = []
    for lay in LAYOUTS:
        if cm.stack_nt(l1, l2, lay, db, pool=pool_t, residual=res) <= 0:
            continue                 # the stack gate refuses the pair
        c1 = cm.fused_chain_cost(l1, lay, db, relu=g1.relu)
        c2 = cm.fused_chain_cost(l2, lay, db, relu=g2.relu, pool=pool_t,
                                 residual=res)
        st = cm.stack_fused_cost(l1, l2, lay, db, pool=pool_t, residual=res)
        extra_compute = st.compute_s - (c1.compute_s + c2.compute_s)
        saved_memory = (c1.memory_s + c2.memory_s) - st.memory_s
        if extra_compute <= saved_memory:
            out.append(lay)
    return tuple(out)


def _pair_stacks(layers: Sequence[LayerDesc], groups: List[_Group],
                 rins: Sequence[Tuple[int, ...]],
                 cons: Dict[int, List[int]], cm: CostModel
                 ) -> Tuple[List[_Group], Dict[int, Tuple[str, ...]]]:
    """Greedy left-to-right pairing of adjacent conv groups into stack
    groups (like epilogue folding, the pairing is structural; the DP then
    arbitrates the stack's LAYOUT among the feasible set).  Returns the new
    group list and, keyed by new-group index, the feasible layouts of each
    stack group — the DP must not place a stack in a layout whose staged
    tile the stack gate refuses."""
    out: List[_Group] = []
    stack_lays: Dict[int, Tuple[str, ...]] = {}
    i = 0
    while i < len(groups):
        g1 = groups[i]
        if i + 1 < len(groups):
            g2 = groups[i + 1]
            if _stackable_pair(layers, g1, g2, rins, cons):
                lays = _stack_layouts(layers, g1, g2, cm)
                if lays:
                    out.append(_Group(g1.start, g2.end, "conv", g2.relu,
                                      g2.pool_index, add_index=g2.add_index,
                                      res_src=g2.res_src,
                                      stack_index=g2.start,
                                      stack_relu=g1.relu))
                    stack_lays[len(out) - 1] = lays
                    i += 2
                    continue
        out.append(g1)
        i += 1
    return out, stack_lays


def _stack_miss_bytes(layers: Sequence[LayerDesc], groups: List[_Group],
                      rins: Sequence[Tuple[int, ...]],
                      cons: Dict[int, List[int]], cm: CostModel) -> int:
    """Round-trip HBM bytes of the mid activations of adjacent conv-group
    pairs that pass BOTH the structural predicate and the profitability
    arbitration yet are not fused in ``groups`` — the plan's
    ``intermediate_roundtrip_bytes``.  Zero after ``_pair_stacks`` by
    construction (every such pair got paired); nonzero means a profitable
    round trip was left on the table, which the bench trajectory gate treats
    as a regression with no tolerance."""
    missed = 0
    for g1, g2 in zip(groups, groups[1:]):
        if not _stackable_pair(layers, g1, g2, rins, cons):
            continue
        if not _stack_layouts(layers, g1, g2, cm):
            continue
        l1 = layers[g1.start].conv
        mid = l1.N * l1.Co * l1.out_hw * l1.out_hw
        missed += 2 * mid * layers[g1.start].dtype_bytes
    return missed


def _group_layouts(layers: Sequence[LayerDesc], groups: List[_Group],
                   stack_lays: Dict[int, Tuple[str, ...]],
                   cm: CostModel) -> List[Tuple[str, ...]]:
    """Per group, the layouts the DP may run it in: a stack group's
    feasible set, a conv group's layouts whose engine can run its chain in
    one launch (the profile's gate; all on the reference's), and every
    layout for the rest."""
    out: List[Tuple[str, ...]] = []
    for gi, g in enumerate(groups):
        l = layers[g.start]
        if gi in stack_lays:
            out.append(stack_lays[gi])
        elif g.kind == "conv" and l.conv is not None:
            lays = tuple(lay for lay in LAYOUTS
                         if cm.chain_fits(l.conv, lay,
                                          _group_pool(layers, g)))
            if not lays:
                raise ValueError(
                    f"layer {l.name!r}: no conv engine of {cm.hw.name} "
                    f"runs this conv in one launch")
            out.append(lays)
        else:
            out.append(LAYOUTS)
    return out


def _group_cost(layers: Sequence[LayerDesc], g: _Group, lay: str,
                training: bool = False,
                in_db: Optional[int] = None,
                out_db: Optional[int] = None,
                cm: Optional[CostModel] = None) -> float:
    cm = cm or default_cost_model()
    l = layers[g.start]
    if g.kind == "conv" and g.stack_index is not None:
        # stack groups are inference-only (pairing is gated on it)
        return cm.stack_fused_cost(l.conv, layers[g.stack_index].conv, lay,
                                   l.dtype_bytes,
                                   pool=_group_pool(layers, g),
                                   residual=g.add_index is not None,
                                   in_dtype_bytes=in_db,
                                   out_dtype_bytes=out_db).total_s
    if g.kind == "conv" and l.conv is not None:
        pool_t = _group_pool(layers, g)
        res = g.add_index is not None
        t = cm.fused_chain_cost(l.conv, lay, l.dtype_bytes,
                                relu=g.relu, pool=pool_t,
                                in_dtype_bytes=in_db,
                                out_dtype_bytes=out_db,
                                residual=res).total_s
        if training:
            # gradients stay at the base dtype — int8 is a forward-storage
            # lever; the backward chain is priced at the layer's dtype
            t += cm.conv_backward_cost(l.conv, lay, l.dtype_bytes,
                                       relu=g.relu, pool=pool_t, fused=True,
                                       residual=res).total_s
        return t
    return sum(layer_cost(layers[i], lay, training, cm)
               for i in range(g.start, g.end))


def _group_hbm_bytes(layers: Sequence[LayerDesc], g: _Group,
                     in_db: int, out_db: int, training: bool,
                     cm: Optional[CostModel] = None) -> int:
    """Secondary DP key: the group's modeled fused HBM bytes.  Layer kinds
    whose traffic is identical across all states (fc/act/flatten, standalone
    merges) contribute 0 — constants never move an argmin.  Time stays the
    primary objective; bytes break ties, which is what lets int8 win on
    compute-bound chains (the paper's currency is bytes moved)."""
    cm = cm or default_cost_model()
    l = layers[g.start]
    if g.kind == "conv" and g.stack_index is not None:
        return cm.stack_bytes(l.conv, layers[g.stack_index].conv,
                              l.dtype_bytes, pool=_group_pool(layers, g),
                              residual=g.add_index is not None,
                              in_dtype_bytes=in_db, out_dtype_bytes=out_db)
    if g.kind == "conv" and l.conv is not None:
        res = g.add_index is not None
        b = cm.chain_bytes(l.conv, l.dtype_bytes, relu=g.relu,
                           pool=_group_pool(layers, g), fused=True,
                           in_dtype_bytes=in_db, out_dtype_bytes=out_db,
                           residual=res)
        if training:
            b += cm.conv_backward_bytes(
                l.conv, "CHWN", l.dtype_bytes, relu=g.relu,
                pool=_group_pool(layers, g), fused=True,
                trainable=l.trainable, residual=res)
        return b
    if g.kind == "pool" and l.pool is not None:
        in_b, out_b = _pool_io_bytes(l)
        return in_b + out_b + ((2 * in_b + out_b) if training else 0)
    return 0


def plan_fused(layers: Sequence[LayerDesc], *,
               input_layout: str = "NCHW",
               input_shape: Optional[Tuple[int, ...]] = None,
               optimized_transform: bool = True,
               training: bool = False,
               dtype_policy: str = "uniform",
               base_dtype: Optional[str] = None,
               stack_policy: str = "auto",
               cost_model: Optional[CostModel] = None,
               _force_graph: bool = False) -> FusedPlan:
    """Turn a layer stack into a fused execution plan.

    Collapses conv[->relu][->pool] runs into fused-op nodes, then runs the
    shortest-path DP over (node, layout, storage dtype) states: node cost
    comes from the fusion cost model (``fused_chain_cost`` — the chain
    intermediate never hits HBM), and an edge costs zero when the re-layout
    folds into the producer's output write or the consumer conv's input
    read.  Standalone transform passes survive only where no adjacent kernel
    can fold them (never, for conv-led CNNs: the first layer is a conv and
    reads the host layout directly).

    ``dtype_policy="mixed"`` lets interior conv chains store
    their output as int8: the quantize folds into the chain's epilogue (the
    f32 accumulator is scaled per channel on its way out) and the
    dequantize into the consumer conv's read (the per-channel scale folds
    exactly into the weights), so the dtype edge is as free as a folding
    layout edge.  Candidates are restricted to edges both sides can fold —
    conv-chain output consumed by another conv chain — and the first conv
    chain's output stays at the base dtype (early features are
    precision-sensitive; ZeroQuant/AWQ keep the first layer wide for the
    same reason).  Because the base-dtype path is always in the search
    space, the mixed plan is never worse than the uniform plan at the same
    base dtype.

    ``training`` plans the whole training graph: chain nodes add the
    custom-VJP backward (activation stash, one-kernel pool+mask backward,
    dgrad/wgrad) to both the time and byte models, the unfused comparison
    adds the plainly decomposed backward, and non-folding transform edges are
    paid twice (forward + the reversed gradient re-layout) — folding edges
    stay free in BOTH directions, because dgrad consumes/produces through
    the same kernel I/O maps.  Gradients stay at the base dtype (the
    straight-through estimator passes them through int8 boundaries), so
    mixed plans shrink forward bytes only.

    ``stack_policy="auto"`` additionally pairs adjacent conv groups into
    two-conv STACK nodes wherever a single halo-fused kernel is legal (the
    profile's stack gate admits it) and profitable (recomputed halo rows
    cost less than the mid activation's round trip saves) — the
    intermediate between the convs then never touches HBM.  Stacks are an
    inference, uniform-dtype lever: training plans (the backward must
    rematerialize the mid) and mixed-dtype plans (int8 interior edges
    already shrink the round trip; composing packed storage with halo
    recompute is future work) never pair, and ``stack_policy="off"``
    disables pairing outright, degenerating byte-identically to the unstacked
    planner.
    """
    if dtype_policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype_policy {dtype_policy!r}; "
                         f"known: {DTYPE_POLICIES}")
    if stack_policy not in ("auto", "off"):
        raise ValueError(f"unknown stack_policy {stack_policy!r}; "
                         "known: ('auto', 'off')")
    cm = cost_model or default_cost_model()
    n = len(layers)
    in_shape = tuple(input_shape) if input_shape else (
        layers[0].out_shape if layers else ())
    base = _base_dtype_name(layers, base_dtype)
    rins = _resolved_inputs(layers)
    if not _is_linear(rins) or _force_graph:
        # branching networks take the frontier DP; linear
        # ones stay on the chain DP below, byte-identical to the pre-DAG
        # planner (``_force_graph`` exists so tests can prove the graph
        # path degenerates to the same plan)
        return _plan_fused_graph(
            layers, rins, input_layout=input_layout, in_shape=in_shape,
            optimized_transform=optimized_transform, training=training,
            dtype_policy=dtype_policy, base=base, stack_policy=stack_policy,
            cm=cm)

    def _in_shape(i: int) -> Tuple[int, ...]:
        return layers[i - 1].out_shape if i else in_shape

    groups = _group_layers(layers, cm)
    cons = _consumers(rins)
    stack_lays: Dict[int, Tuple[str, ...]] = {}
    if stack_policy == "auto" and not training and dtype_policy == "uniform":
        groups, stack_lays = _pair_stacks(layers, groups, rins, cons, cm)
    roundtrip_b = _stack_miss_bytes(layers, groups, rins, cons, cm)
    group_lays = _group_layouts(layers, groups, stack_lays, cm)
    first_conv = next((gi for gi, g in enumerate(groups)
                       if g.kind == "conv"), -1)

    def gcands(gi: int) -> Tuple[str, ...]:
        # a group's OUTPUT may store int8 only when both casts fold: the
        # producer is a conv chain (epilogue quantizes) and the consumer is
        # a conv chain (dequantizes on chip); the first conv chain stays at
        # base (precision-sensitive early features)
        g = groups[gi]
        if (dtype_policy == "mixed" and g.kind == "conv" and gi > first_conv
                and gi + 1 < len(groups) and groups[gi + 1].kind == "conv"):
            return (base, INT8_DTYPE)
        return (base,)

    # DP over (group, layout, out dtype); layout edges fold into conv/pool
    # kernel I/O maps, dtype edges into conv epilogues/reads (see gcands).
    # Costs are lexicographic (seconds, HBM bytes): on compute-bound chains
    # the roofline max() hides byte savings, and the byte tie-break is what
    # makes the dtype dimension decisive there.
    INF = (float("inf"), float("inf"))
    State = Tuple[str, str]
    dp: Dict[State, Tuple[Tuple[float, float], List[State]]] = {
        (lay, base): (((0.0, 0.0) if lay == input_layout else INF), [])
        for lay in LAYOUTS}
    for gi, g in enumerate(groups):
        l = layers[g.start]
        ndp: Dict[State, Tuple[Tuple[float, float], List[State]]] = {}
        # a group runs only in layouts the profile's gates admit
        for lay in group_lays[gi]:
            for dt in gcands(gi):
                best, path = INF, None
                for (prev, prev_dt), (c0, p0) in dp.items():
                    edge_s, edge_b = 0.0, 0.0
                    if prev != lay:
                        prev_g = groups[len(p0) - 1] if p0 else None
                        folds = (g.kind == "conv" or
                                 (prev_g is not None and
                                  prev_g.kind in ("conv", "pool")))
                        if not folds:
                            tx_e = 2 if training else 1
                            edge_s = tx_e * transform_cost(
                                _in_shape(g.start), _dtype_bytes(prev_dt),
                                optimized_transform, hw=cm.hw)
                            edge_b = tx_e * transform_bytes(
                                _in_shape(g.start), _dtype_bytes(prev_dt))
                    in_db, out_db = _dtype_bytes(prev_dt), _dtype_bytes(dt)
                    c = (c0[0] + edge_s +
                         _group_cost(layers, g, lay, training,
                                     in_db=in_db, out_db=out_db, cm=cm),
                         c0[1] + edge_b +
                         _group_hbm_bytes(layers, g, in_db, out_db,
                                          training, cm))
                    if c < best:
                        best, path = c, p0 + [(lay, dt)]
                ndp[(lay, dt)] = (best, path)
        dp = ndp
    st_best = min(dp, key=lambda k: dp[k][0])
    _, gpath = dp[st_best]
    layouts: List[str] = [""] * n
    dtypes: List[str] = [base] * n
    for g, (glay, gdt) in zip(groups, gpath):
        for i in range(g.start, g.end):
            layouts[i] = glay
            dtypes[i] = gdt

    ops: List[FusedOp] = []
    transforms: List[int] = []
    total = 0.0
    fused_b = 0
    unfused_b = 0
    cur = input_layout
    cur_dt = base
    flat = False
    for g, (lay, gdt) in zip(groups, gpath):
        i = g.start
        l = layers[i]
        tx = 2 if training else 1    # gradients re-layout back through edges
        if g.kind == "conv" and g.stack_index is not None:
            dst = _dst_layout(layers, layouts, g.end, lay)
            pool_t = _group_pool(layers, g)
            in_db, out_db = _dtype_bytes(cur_dt), _dtype_bytes(gdt)
            l2 = layers[g.stack_index]
            ops.append(FusedOp("conv", i, l.name, lay, cur, dst,
                               relu=g.relu, pool_index=g.pool_index,
                               src_dtype=cur_dt, dst_dtype=gdt,
                               stack_index=g.stack_index,
                               stack_relu=g.stack_relu))
            total += cm.stack_fused_cost(l.conv, l2.conv, lay, l.dtype_bytes,
                                         pool=pool_t, residual=False,
                                         in_dtype_bytes=in_db,
                                         out_dtype_bytes=out_db).total_s
            fused_b += cm.stack_bytes(l.conv, l2.conv, l.dtype_bytes,
                                      pool=pool_t, residual=False,
                                      in_dtype_bytes=in_db,
                                      out_dtype_bytes=out_db)
            # the unfused comparison runs both convs separately, mid
            # activation round-tripping through HBM
            unfused_b += (cm.chain_bytes(l.conv, l.dtype_bytes,
                                         relu=g.stack_relu, fused=False) +
                          cm.chain_bytes(l2.conv, l.dtype_bytes, relu=g.relu,
                                         pool=pool_t, fused=False))
            if cur != lay:           # folded into the kernel's input read
                unfused_b += tx * transform_bytes(_in_shape(i), l.dtype_bytes)
            if dst != lay:           # folded into the kernel's output write
                unfused_b += tx * transform_bytes(
                    layers[g.end - 1].out_shape, l.dtype_bytes)
            cur = dst
            cur_dt = gdt
            continue
        if g.kind == "conv":
            dst = _dst_layout(layers, layouts, g.end, lay)
            pool_t = _group_pool(layers, g)
            in_db, out_db = _dtype_bytes(cur_dt), _dtype_bytes(gdt)
            ops.append(FusedOp("conv", i, l.name, lay, cur, dst,
                               relu=g.relu, pool_index=g.pool_index,
                               src_dtype=cur_dt, dst_dtype=gdt))
            total += cm.fused_chain_cost(l.conv, lay, l.dtype_bytes,
                                         relu=g.relu, pool=pool_t,
                                         in_dtype_bytes=in_db,
                                         out_dtype_bytes=out_db).total_s
            fused_b += cm.chain_bytes(l.conv, l.dtype_bytes, relu=g.relu,
                                      pool=pool_t, fused=True,
                                      in_dtype_bytes=in_db,
                                      out_dtype_bytes=out_db)
            # the unfused comparison runs uniformly at the base dtype — the
            # unfused engine has no epilogue to fold the casts into
            unfused_b += cm.chain_bytes(l.conv, l.dtype_bytes, relu=g.relu,
                                        pool=pool_t, fused=False)
            if training:
                total += cm.conv_backward_cost(l.conv, lay, l.dtype_bytes,
                                               relu=g.relu, pool=pool_t,
                                               fused=True).total_s
                fused_b += cm.conv_backward_bytes(
                    l.conv, lay, l.dtype_bytes, relu=g.relu, pool=pool_t,
                    fused=True, trainable=l.trainable)
                unfused_b += cm.conv_backward_bytes(
                    l.conv, lay, l.dtype_bytes, relu=g.relu, pool=pool_t,
                    fused=False, trainable=l.trainable)
            if cur != lay:           # folded into the kernel's input read
                unfused_b += tx * transform_bytes(_in_shape(i), l.dtype_bytes)
            if dst != lay:           # folded into the kernel's output write
                unfused_b += tx * transform_bytes(
                    layers[g.end - 1].out_shape, l.dtype_bytes)
            cur = dst
            cur_dt = gdt
            continue
        if g.kind == "pool" and l.pool is not None and not flat:
            if cur != lay:           # no producer to fold into: standalone
                transforms.append(i)
                total += tx * transform_cost(_in_shape(i), l.dtype_bytes,
                                             optimized_transform, hw=cm.hw)
                tb = tx * transform_bytes(_in_shape(i), l.dtype_bytes)
                fused_b += tb
                unfused_b += tb
                cur = lay
            dst = _dst_layout(layers, layouts, g.end, lay)
            ops.append(FusedOp("pool", i, l.name, lay, cur, dst,
                               src_dtype=cur_dt, dst_dtype=gdt))
            total += layer_cost(l, lay, training, cm)
            in_b, out_b = _pool_io_bytes(l)
            io_b = in_b + out_b
            if training:             # bwd: read g + read input (mask) + write
                io_b += 2 * in_b + out_b
            fused_b += io_b
            unfused_b += io_b
            if dst != lay:           # folded into the pool's output write
                unfused_b += tx * transform_bytes(l.out_shape, l.dtype_bytes)
            cur = dst
            continue
        # layout-terminal / elementwise leftovers
        sz = int(np.prod(l.out_shape)) if l.out_shape else 0
        if l.kind == "flatten":
            flat = True
            fused_b += tx * 2 * sz * l.dtype_bytes if cur == "CHWN" else 0
            unfused_b += tx * 2 * sz * l.dtype_bytes if lay == "CHWN" else 0
        elif l.kind == "fc":
            in_f = (int(np.prod(layers[i - 1].out_shape)) // l.out_shape[0]
                    if i else l.out_shape[1])
            io_b = (int(np.prod(l.out_shape)) + in_f * l.out_shape[1] +
                    l.out_shape[1] + in_f * l.out_shape[0]) * l.dtype_bytes
            if training:             # dx = g W^T, dW = x^T g, db
                io_b *= 2
            fused_b += io_b
            unfused_b += io_b
        else:                        # act / softmax
            total += layer_cost(l, lay, training, cm)
            io_b = (5 if training else 2) * sz * l.dtype_bytes
            fused_b += io_b
            unfused_b += io_b
        ops.append(FusedOp(l.kind, i, l.name, lay, cur, cur if flat else lay,
                           src_dtype=cur_dt, dst_dtype=gdt))
    return FusedPlan(layouts=layouts, ops=ops, transforms=transforms,
                     total_s=total, fused_bytes=fused_b,
                     unfused_bytes=unfused_b, dtypes=dtypes,
                     base_dtype=base,
                     intermediate_roundtrip_bytes=roundtrip_b)


# ---------------------------------------------------------------------------
# DAG planning
# ---------------------------------------------------------------------------

def _assign_layouts_graph(layers: Sequence[LayerDesc],
                          rins: Sequence[Tuple[int, ...]], *,
                          input_layout: str, in_shape: Tuple[int, ...],
                          optimized_transform: bool, training: bool,
                          cost_fn: Callable[[LayerDesc, str], float],
                          dtype_policy: str, base: str, base_db: int,
                          cm: Optional[CostModel] = None) -> Assignment:
    """Frontier DP over a DAG for the UNFUSED engine.  The state is the
    (layout, dtype) of every LIVE edge — a produced tensor still awaiting a
    consumer — so a merge node prices the transform/cast of each incoming
    branch independently, and a fork's producer is paid once while every
    consumer pays its own mismatch.  On a linear graph this is the same
    shortest path ``assign_layouts`` computes (one live edge at all times)."""
    cm = cm or default_cost_model()
    n = len(layers)
    cons = _consumers(rins)
    # an edge retires after its LAST consumer runs
    last_use = {p: max(c) for p, c in cons.items() if c}
    tx = 2 if training else 1

    def cands(i: int) -> Tuple[str, ...]:
        if (dtype_policy == "mixed" and i + 1 < n
                and layers[i].kind == "conv"):
            return (base, INT8_DTYPE)
        return (base,)

    def shape_of(p: int) -> Tuple[int, ...]:
        return in_shape if p < 0 else layers[p].out_shape

    # state: sorted tuple of (producer layer index, layout, dtype); -1 is
    # the network input
    State = Tuple[Tuple[int, str, str], ...]
    init: State = ((-1, input_layout, base),)
    dp: Dict[State, Tuple[float, List[Tuple[str, str]]]] = {init: (0.0, [])}
    for i, l in enumerate(layers):
        ndp: Dict[State, Tuple[float, List[Tuple[str, str]]]] = {}
        for st, (c0, asg) in dp.items():
            by_p = {e[0]: (e[1], e[2]) for e in st}
            for lay in LAYOUTS:
                for dt in cands(i):
                    c = c0 + cost_fn(l, lay)
                    for p in rins[i]:
                        p_lay, p_dt = by_p[p]
                        sh = shape_of(p)
                        if p_dt != base:    # dequant pass before compute
                            c += tx * cm.cast_cost(sh, _dtype_bytes(p_dt),
                                                   base_db)
                        if p_lay != lay:
                            c += tx * transform_cost(sh, _dtype_bytes(p_dt),
                                                     optimized_transform,
                                                     hw=cm.hw)
                    if dt != base:          # quant pass after compute
                        c += tx * cm.cast_cost(l.out_shape, base_db,
                                               _dtype_bytes(dt))
                    nst = tuple(sorted(
                        [e for e in st if last_use.get(e[0], -1) > i] +
                        ([(i, lay, dt)] if last_use.get(i, -1) > i else [])))
                    prev = ndp.get(nst)
                    if prev is None or c < prev[0]:
                        ndp[nst] = (c, asg + [(lay, dt)])
        dp = ndp
    total, path = min(dp.values(), key=lambda v: v[0])
    layouts = [st[0] for st in path]
    dtypes = [st[1] for st in path]
    transforms = [i for i in range(n)
                  if any((layouts[p] if p >= 0 else input_layout)
                         != layouts[i] for p in rins[i])]
    return Assignment(layouts=layouts, transforms=transforms, total_s=total,
                      dtypes=dtypes)


def _plan_fused_graph(layers: Sequence[LayerDesc],
                      rins: Sequence[Tuple[int, ...]], *,
                      input_layout: str, in_shape: Tuple[int, ...],
                      optimized_transform: bool, training: bool,
                      dtype_policy: str, base: str,
                      stack_policy: str = "auto",
                      cm: Optional[CostModel] = None) -> FusedPlan:
    """Fused-op planning over a DAG.

    Groups are conv[->add][->act][->pool] chains built by
    ``_group_layers_graph`` — a residual add rides the conv epilogue (the
    skip tensor is read straight into the accumulator through a second,
    layout-folding read), so it costs ONE extra stream read instead of
    a standalone read+read+write pass.  The DP is a frontier DP: the state
    is the (stored layout, dtype) of every live group-output edge, and each
    incoming edge of a group prices per its role:

    * ``main`` — free when the consumer is a conv (its input read folds the
      read) or when the producer is a conv/pool whose SOLE consumer this is
      (its output write folds the layout); otherwise a standalone transform.
    * ``aux`` — second operand of a standalone add/concat: pays a transform
      on any layout mismatch (no kernel to fold into).
    * ``res`` — the folded skip tensor: free in ANY layout (that is the
      point of the second read).

    Mixed-dtype candidates keep the chain DP's fold-or-forget discipline:
    a group may store int8 only when its tail has exactly one consumer and
    that consumer is a conv group reading it as the MAIN input — a skip or
    concat consumer keeps the edge at the base dtype, which is how the
    merge-node dtype join stays correct by construction."""
    cm = cm or default_cost_model()
    n = len(layers)
    cons = _consumers(rins)
    groups = _group_layers_graph(layers, rins, cons, cm)
    stack_lays: Dict[int, Tuple[str, ...]] = {}
    if stack_policy == "auto" and not training and dtype_policy == "uniform":
        groups, stack_lays = _pair_stacks(layers, groups, rins, cons, cm)
    roundtrip_b = _stack_miss_bytes(layers, groups, rins, cons, cm)
    group_lays = _group_layouts(layers, groups, stack_lays, cm)
    g_of: Dict[int, int] = {}
    for gi, g in enumerate(groups):
        for i in range(g.start, g.end):
            g_of[i] = gi
    # producer layer index -> last consuming GROUP index (edge lifetime)
    last_g: Dict[int, int] = {}
    for p, cs in cons.items():
        ext = [g_of[c] for c in cs if p < 0 or g_of[c] != g_of[p]]
        if ext:
            last_g[p] = max(ext)
    first_conv = next((gi for gi, g in enumerate(groups)
                       if g.kind == "conv"), -1)

    def shape_of(p: int) -> Tuple[int, ...]:
        return in_shape if p < 0 else layers[p].out_shape

    def gcands(gi: int) -> Tuple[str, ...]:
        g = groups[gi]
        if (dtype_policy != "mixed" or g.kind != "conv"
                or gi <= first_conv):
            return (base,)
        t = g.end - 1
        cs = cons[t]
        if len(cs) != 1:             # forks must stay castable-free: base
            return (base,)
        c = cs[0]
        cg = groups[g_of[c]]
        if cg.kind == "conv" and c == cg.start and rins[c][0] == t:
            return (base, INT8_DTYPE)   # sole conv MAIN consumer: both fold
        return (base,)

    def edge_cost(g: _Group, lay: str, p: int, s_lay: str, s_dt: str,
                  role: str) -> Tuple[float, int]:
        if role == "res":
            return 0.0, 0            # the second read folds any layout
        if role == "main" and g.kind == "conv":
            return 0.0, 0            # conv reads any src layout (read-fold)
        if s_lay == lay:
            return 0.0, 0
        if (p >= 0 and groups[g_of[p]].kind in ("conv", "pool")
                and len(cons[p]) == 1):
            return 0.0, 0            # producer writes our layout (write-fold)
        tx_e = 2 if training else 1
        db = _dtype_bytes(s_dt)
        return (tx_e * transform_cost(shape_of(p), db, optimized_transform,
                                      hw=cm.hw),
                tx_e * transform_bytes(shape_of(p), db))

    # frontier DP; state = sorted tuple of (producer layer, layout, dtype)
    INF = (float("inf"), float("inf"))
    State = Tuple[Tuple[int, str, str], ...]
    init: State = ((-1, input_layout, base),)
    dp: Dict[State, Tuple[Tuple[float, float], List[Tuple[str, str]]]] = {
        init: ((0.0, 0.0), [])}
    for gi, g in enumerate(groups):
        h = g.start
        ndp: Dict[State, Tuple[Tuple[float, float],
                               List[Tuple[str, str]]]] = {}
        for st, (c0, p0) in dp.items():
            by_p = {e[0]: (e[1], e[2]) for e in st}
            # a group runs only in layouts the profile's gates admit
            for lay in group_lays[gi]:
                for dt in gcands(gi):
                    s, b = c0
                    in_db = None
                    for k, p in enumerate(rins[h]):
                        s_lay, s_dt = by_p[p]
                        role = "main" if k == 0 else "aux"
                        es, eb = edge_cost(g, lay, p, s_lay, s_dt, role)
                        s += es
                        b += eb
                        if role == "main":
                            in_db = _dtype_bytes(s_dt)
                    out_db = _dtype_bytes(dt)
                    s += _group_cost(layers, g, lay, training,
                                     in_db=in_db, out_db=out_db, cm=cm)
                    b += _group_hbm_bytes(layers, g, in_db, out_db,
                                          training, cm)
                    t = g.end - 1
                    nst = tuple(sorted(
                        [e for e in st if last_g.get(e[0], -1) > gi] +
                        ([(t, lay, dt)] if last_g.get(t, -1) > gi else [])))
                    prev = ndp.get(nst)
                    if prev is None or (s, b) < prev[0]:
                        ndp[nst] = ((s, b), p0 + [(lay, dt)])
        dp = ndp
    _, gpath = min(dp.values(), key=lambda v: v[0])

    layouts: List[str] = [""] * n
    dtypes: List[str] = [base] * n
    for g, (glay, gdt) in zip(groups, gpath):
        for i in range(g.start, g.end):
            layouts[i] = glay
            dtypes[i] = gdt

    # --- emission -----------------------------------------------------------
    # stored[p] = (layout, dtype) the tensor produced by layer p sits in HBM
    # as; write-folds (a conv/pool producer with a sole consumer writes the
    # consumer's preferred layout directly) are applied here, so a consumer
    # pays a standalone transform exactly when stored layout != its layout
    # and it cannot read-fold.
    stored: Dict[int, Tuple[str, str]] = {-1: (input_layout, base)}
    ops: List[FusedOp] = []
    transforms: List[int] = []
    total = 0.0
    fused_b = 0
    unfused_b = 0
    tx = 2 if training else 1
    flat = False
    for gi, (g, (lay, gdt)) in enumerate(zip(groups, gpath)):
        h = g.start
        l = layers[h]
        t = g.end - 1
        cs = cons[t]
        dst = lay
        if len(cs) == 1 and g.kind in ("conv", "pool") and not flat:
            c = cs[0]
            cg = groups[g_of[c]]
            if cg.add_index == c and cg.res_src == t:
                dst = lay            # a res read folds any layout: keep ours
            elif layers[c].kind in ("flatten", "fc", "softmax"):
                dst = "NCHW"         # free 2-D reshape ahead of the head
            else:
                dst = layouts[c]
        stored[t] = (dst, gdt)
        if g.kind == "conv" and g.stack_index is not None:
            p = rins[h][0]
            src_lay, src_dt = stored[p]
            in_db, out_db = _dtype_bytes(src_dt), _dtype_bytes(gdt)
            pool_t = _group_pool(layers, g)
            res = g.add_index is not None
            res_lay = stored[g.res_src][0] if res else ""
            l2 = layers[g.stack_index]
            ops.append(FusedOp("conv", h, l.name, lay, src_lay, dst,
                               relu=g.relu, pool_index=g.pool_index,
                               src_dtype=src_dt, dst_dtype=gdt,
                               inputs=(p,), out_index=t,
                               add_index=g.add_index, res_index=g.res_src,
                               res_layout=res_lay,
                               stack_index=g.stack_index,
                               stack_relu=g.stack_relu))
            total += cm.stack_fused_cost(l.conv, l2.conv, lay, l.dtype_bytes,
                                         pool=pool_t, residual=res,
                                         in_dtype_bytes=in_db,
                                         out_dtype_bytes=out_db).total_s
            fused_b += cm.stack_bytes(l.conv, l2.conv, l.dtype_bytes,
                                      pool=pool_t, residual=res,
                                      in_dtype_bytes=in_db,
                                      out_dtype_bytes=out_db)
            unfused_b += (cm.chain_bytes(l.conv, l.dtype_bytes,
                                         relu=g.stack_relu, fused=False) +
                          cm.chain_bytes(l2.conv, l.dtype_bytes, relu=g.relu,
                                         pool=pool_t, fused=False,
                                         residual=res))
            if src_lay != lay:       # folded into the kernel's input read
                unfused_b += tx * transform_bytes(shape_of(p), l.dtype_bytes)
            if dst != lay:           # folded into the kernel's output write
                unfused_b += tx * transform_bytes(layers[t].out_shape,
                                                  l.dtype_bytes)
            if res and res_lay != lay:   # folded into the skip's second read
                unfused_b += tx * transform_bytes(shape_of(g.res_src),
                                                  l.dtype_bytes)
            continue
        if g.kind == "conv":
            p = rins[h][0]
            src_lay, src_dt = stored[p]
            in_db, out_db = _dtype_bytes(src_dt), _dtype_bytes(gdt)
            pool_t = _group_pool(layers, g)
            res = g.add_index is not None
            res_lay = stored[g.res_src][0] if res else ""
            ops.append(FusedOp("conv", h, l.name, lay, src_lay, dst,
                               relu=g.relu, pool_index=g.pool_index,
                               src_dtype=src_dt, dst_dtype=gdt,
                               inputs=(p,), out_index=t,
                               add_index=g.add_index, res_index=g.res_src,
                               res_layout=res_lay))
            total += cm.fused_chain_cost(l.conv, lay, l.dtype_bytes,
                                         relu=g.relu, pool=pool_t,
                                         in_dtype_bytes=in_db,
                                         out_dtype_bytes=out_db,
                                         residual=res).total_s
            fused_b += cm.chain_bytes(l.conv, l.dtype_bytes, relu=g.relu,
                                      pool=pool_t, fused=True,
                                      in_dtype_bytes=in_db,
                                      out_dtype_bytes=out_db, residual=res)
            unfused_b += cm.chain_bytes(l.conv, l.dtype_bytes, relu=g.relu,
                                        pool=pool_t, fused=False,
                                        residual=res)
            if training:
                total += cm.conv_backward_cost(l.conv, lay, l.dtype_bytes,
                                               relu=g.relu, pool=pool_t,
                                               fused=True,
                                               residual=res).total_s
                fused_b += cm.conv_backward_bytes(
                    l.conv, lay, l.dtype_bytes, relu=g.relu, pool=pool_t,
                    fused=True, trainable=l.trainable, residual=res)
                unfused_b += cm.conv_backward_bytes(
                    l.conv, lay, l.dtype_bytes, relu=g.relu, pool=pool_t,
                    fused=False, trainable=l.trainable, residual=res)
            if src_lay != lay:       # folded into the kernel's input read
                unfused_b += tx * transform_bytes(shape_of(p), l.dtype_bytes)
            if dst != lay:           # folded into the kernel's output write
                unfused_b += tx * transform_bytes(layers[t].out_shape,
                                                  l.dtype_bytes)
            if res and res_lay != lay:   # folded into the skip's second read
                unfused_b += tx * transform_bytes(shape_of(g.res_src),
                                                  l.dtype_bytes)
            continue
        if g.kind == "pool" and l.pool is not None and not flat:
            p = rins[h][0]
            src_lay, src_dt = stored[p]
            if src_lay != lay:       # no producer to fold into: standalone
                transforms.append(h)
                total += tx * transform_cost(shape_of(p), l.dtype_bytes,
                                             optimized_transform, hw=cm.hw)
                tb = tx * transform_bytes(shape_of(p), l.dtype_bytes)
                fused_b += tb
                unfused_b += tb
                src_lay = lay
            ops.append(FusedOp("pool", h, l.name, lay, src_lay, dst,
                               src_dtype=src_dt, dst_dtype=gdt,
                               inputs=(p,), out_index=t))
            total += layer_cost(l, lay, training, cm)
            in_b, out_b = _pool_io_bytes(l)
            io_b = in_b + out_b + ((2 * in_b + out_b) if training else 0)
            fused_b += io_b
            unfused_b += io_b
            if dst != lay:           # folded into the pool's output write
                unfused_b += tx * transform_bytes(l.out_shape, l.dtype_bytes)
            continue
        if l.kind in ("add", "concat", "upsample"):
            ins = rins[h]
            srcs = [stored[p] for p in ins]
            for p, (s_lay, _) in zip(ins, srcs):
                if s_lay != lay:     # standalone merge: every mismatch pays
                    if h not in transforms:
                        transforms.append(h)
                    total += tx * transform_cost(shape_of(p), l.dtype_bytes,
                                                 optimized_transform, hw=cm.hw)
                    tb = tx * transform_bytes(shape_of(p), l.dtype_bytes)
                    fused_b += tb
                    unfused_b += tb
            ops.append(FusedOp(l.kind, h, l.name, lay, srcs[0][0], dst,
                               src_dtype=srcs[0][1], dst_dtype=gdt,
                               inputs=tuple(ins), out_index=h))
            total += layer_cost(l, lay, training, cm)
            io_b = _merge_io_bytes(l, training)
            fused_b += io_b
            unfused_b += io_b
            continue
        # layout-terminal / elementwise leftovers
        p = rins[h][0]
        src_lay, src_dt = stored[p]
        sz = int(np.prod(l.out_shape)) if l.out_shape else 0
        if l.kind == "act" and not flat and src_lay != lay:
            transforms.append(h)     # standalone act can't fold a re-layout
            total += tx * transform_cost(shape_of(p), l.dtype_bytes,
                                         optimized_transform, hw=cm.hw)
            tb = tx * transform_bytes(shape_of(p), l.dtype_bytes)
            fused_b += tb
            unfused_b += tb
            src_lay = lay
        if l.kind == "flatten":
            flat = True
            fused_b += tx * 2 * sz * l.dtype_bytes if src_lay == "CHWN" else 0
            unfused_b += tx * 2 * sz * l.dtype_bytes if lay == "CHWN" else 0
        elif l.kind == "fc":
            in_f = (int(np.prod(layers[p].out_shape)) // l.out_shape[0]
                    if p >= 0 else l.out_shape[1])
            io_b = (int(np.prod(l.out_shape)) + in_f * l.out_shape[1] +
                    l.out_shape[1] + in_f * l.out_shape[0]) * l.dtype_bytes
            if training:             # dx = g W^T, dW = x^T g, db
                io_b *= 2
            fused_b += io_b
            unfused_b += io_b
        else:                        # act / softmax
            total += layer_cost(l, lay, training, cm)
            io_b = (5 if training else 2) * sz * l.dtype_bytes
            fused_b += io_b
            unfused_b += io_b
        stored[t] = (src_lay if flat else dst, gdt)
        ops.append(FusedOp(l.kind, h, l.name, lay, src_lay,
                           src_lay if flat else dst,
                           src_dtype=src_dt, dst_dtype=gdt,
                           inputs=(p,), out_index=h))
    return FusedPlan(layouts=layouts, ops=ops, transforms=transforms,
                     total_s=total, fused_bytes=fused_b,
                     unfused_bytes=unfused_b, dtypes=dtypes,
                     base_dtype=base,
                     intermediate_roundtrip_bytes=roundtrip_b)
