"""Logical-axis sharding system (from ``repro.parallel.sharding``).

Every parameter and activation of the model zoo carries logical axis
names (``"embed"``, ``"ff"``, ``"heads"``, ``"batch"``, ...); an
:class:`AxisRules` table maps them to mesh axes, and the layout knobs
select the table (FSDP / TP / EP / SP): ``ShardConfig.resolve(mesh)``
gives the final rules for a mesh and :func:`logical_to_spec` a leaf's
spec, the tuple of mesh axes of each dimension (the counterpart of a
``PartitionSpec``).  :func:`shardings_for` turns a tree of shapes and
logical axes into :class:`Placement` s, the counterpart of a
``NamedSharding``: each rank's block of a leaf, in the block order
``NamedSharding`` uses.

The mesh is a process mesh (``launch.mesh.ProcessMesh``): one process per
device, ranks in ``Mesh.devices.flat`` order.  ``with mesh:`` installs it
as the ambient mesh (:func:`ambient_mesh`), which
:func:`data_parallel_size`, :func:`shard_activation` and
:func:`gather_weights_for_compute` read, as the reference's read its
``with mesh:``; off a mesh they are what they were on one process (1, and
no-ops).  The tensors a rank holds are its blocks; the layers
(``models/``) run Megatron's column- and row-parallel forms over the
``model`` axis, under sequence parallelism with the residual stream split
along the sequence over it (:func:`sequence_parallel_on`), and
:func:`gather_weights_for_compute` is ZeRO-3's just-in-time all-gather
over the data axes (``parallel/collectives.py``).
Any object with ``axis_names`` and a ``shape`` dict serves as a mesh for
the pure functions here.

The proposer's side is ported: the candidate pool of
``gp.select_batch_sharded`` shards over an ordered tuple of devices
(:func:`pool_devices`, axis :data:`POOL_AXIS`), and :func:`spare_device`
picks the card background work (the GP refit) runs on.  The reference's
``pool_mesh`` returns a ``jax.sharding.Mesh``; what it carries, the ordered
device tuple and its axis name, is :func:`pool_devices` and
:data:`POOL_AXIS` here.  No process group is involved: one process drives
every card of the tuple in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]    # one entry per dimension, trailing Nones cut

POOL_AXIS = "pool"


def pool_devices(n: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda") -> Tuple:
    """The devices the proposer's candidate pool shards over: the first
    ``n`` cards of the host (all of them when ``n`` is None or exceeds
    the host), ``(cpu,)`` for a CPU strategy.  Deterministic order:
    shard k owns pool rows ``[k·M/nd, (k+1)·M/nd)``, so the tuple is part
    of the pick-reproducibility contract."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),)
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    if n is not None:
        devs = devs[:max(int(n), 1)]
    return devs


def spare_device(avoid_index: int = 0,
                 device: Union[str, torch.device] = "cuda"):
    """A card for background work (the GP refit executor): the *last*
    card of the host when it has more than one, never ``avoid_index``
    (the experiment loop's), else ``None`` (one card, or a CPU strategy:
    background work shares the device and only thread-yields)."""
    devs = pool_devices(None, device)
    if len(devs) <= 1:
        return None
    for d in reversed(devs):
        if d.index != avoid_index:
            return d
    return None


@dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to mesh axes (None = replicate)."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def to_dict(self) -> Dict[str, MeshAxes]:
        return dict(self.rules)

    def with_rule(self, logical: str, mesh_axes: MeshAxes) -> "AxisRules":
        d = self.to_dict()
        d[logical] = mesh_axes
        return AxisRules(tuple(d.items()))

    def mesh_axes_for(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.to_dict().get(logical, None)


# The "megatron + fsdp" default layout on the fixed (data, model) mesh.
DEFAULT_RULES = AxisRules(
    (
        ("batch", ("data",)),          # activation batch
        ("seq", None),                 # sequence (SP off by default)
        ("embed", None),               # d_model dim of activations
        ("vocab", "model"),            # embedding table vocab dim
        ("emb_embed", None),           # embedding table d_model dim
        ("heads", "model"),            # attention heads (TP)
        ("kv_heads", "model"),         # kv heads (TP; requires kv>=tp or repl)
        ("head_dim", None),
        ("qkv_in", "fsdp"),            # contraction dim of qkv proj (FSDP)
        ("o_out", "fsdp"),             # output dim of o proj (FSDP)
        ("ff", "model"),               # MLP hidden (TP)
        ("ff_in", "fsdp"),             # MLP input dim (FSDP)
        ("experts", "model"),          # MoE expert dim (EP over model axis)
        ("expert_ff", "model"),        # TP inside experts when EP cannot
        ("expert_in", "fsdp"),
        ("kv_seq", None),              # KV-cache sequence dim
        ("ssm_inner", "model"),        # mamba/xlstm inner width (TP)
        ("ssm_in", "fsdp"),
        ("ssm_state", None),
        ("fsdp", None),                # placeholder resolved on a mesh
    )
)

# the ROADMAP item of the layout the sharded steps refuse on a mesh with
# more than one rank
WHISPER_ITEM = "ROADMAP A 18e (whisper)"


@dataclass(frozen=True)
class ShardConfig:
    """Resolved distribution layout — the output of the layout knobs."""

    fsdp: bool = True                    # shard param "fsdp" dims over data axis
    tensor_parallel: bool = True         # map "model"-tagged dims to mesh model
    expert_parallel: bool = True         # shard experts over model axis
    sequence_parallel: bool = False      # shard activation seq over model axis
    shard_kv_seq_for_decode: bool = False  # flash-decode style KV seq sharding
    pod_in_batch: bool = True            # multi-pod: pod axis joins batch
    rules: AxisRules = DEFAULT_RULES

    def resolve(self, mesh) -> AxisRules:
        """Produce final rules for a concrete mesh."""
        axis_names = set(mesh.axis_names)
        d = self.rules.to_dict()

        # FSDP placeholder: "fsdp"-tagged dims shard over the data axis (and
        # pod axis — ZeRO-3 across the full DP world) when fsdp is on.
        fsdp_axes: MeshAxes = None
        if self.fsdp:
            fsdp_axes = ("pod", "data") if "pod" in axis_names else ("data",)
        for k, v in list(d.items()):
            if v == "fsdp" or v == ("fsdp",):
                d[k] = fsdp_axes

        # Batch axis: include pod for multi-pod DP.
        if "pod" in axis_names and self.pod_in_batch:
            d["batch"] = ("pod", "data")
        else:
            d["batch"] = ("data",)

        if not self.tensor_parallel:
            for k in ("heads", "kv_heads", "ff", "vocab", "ssm_inner"):
                d[k] = None
        if not self.expert_parallel:
            d["experts"] = None
        if self.sequence_parallel:
            d["seq"] = ("model",)
        if self.shard_kv_seq_for_decode:
            d["kv_seq"] = ("data",)
        d.pop("fsdp", None)
        return AxisRules(tuple(d.items()))


def shard_config_from_knobs(knobs: Dict[str, object]) -> ShardConfig:
    """Translate SAPPHIRE layout knobs into a ShardConfig (module selection)."""
    return ShardConfig(
        fsdp=bool(knobs.get("fsdp_shard_params", True)),
        tensor_parallel=bool(knobs.get("tensor_parallel", True)),
        expert_parallel=bool(knobs.get("expert_parallel", True)),
        sequence_parallel=bool(knobs.get("sequence_parallel", False)),
        shard_kv_seq_for_decode=bool(knobs.get("shard_kv_seq", False)),
        pod_in_batch=bool(knobs.get("pod_in_batch", True)),
    )


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _as_axes(mesh_axes: MeshAxes) -> Tuple[str, ...]:
    if mesh_axes is None:
        return ()
    return (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: AxisRules,
                    mesh, shape: Optional[Sequence[int]] = None) -> Spec:
    """A tuple of logical axis names -> the spec: per dimension None, one
    mesh axis or a tuple of them; trailing Nones are cut, as
    ``PartitionSpec`` pads them.

    Guards against (a) mesh axes the mesh does not have, (b) using the
    same mesh axis twice in one spec, and, when ``shape`` is given,
    (c) dims not divisible by their mesh-axis product.  The divisibility
    check runs BEFORE an axis is marked used, so a non-divisible dim
    releases its mesh axis to later dims (grok-1: 8 experts cannot take
    the 16-way model axis, so expert_ff picks it up)."""
    axis_names = set(mesh.axis_names)
    sizes = _mesh_shape(mesh)
    dims = list(shape) + [None] * len(logical_axes) if shape is not None \
        else [None] * len(logical_axes)
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        mesh_axes = _as_axes(rules.mesh_axes_for(name))
        ok = tuple(a for a in mesh_axes if a in axis_names and a not in used)
        if not ok:
            out.append(None)
            continue
        if dims[i] is not None:
            size = 1
            for a in ok:
                size *= sizes[a]
            if size <= 1 or dims[i] % size != 0:
                out.append(None)          # axis NOT consumed: stays free
                continue
        used.update(ok)
        out.append(ok if len(ok) > 1 else ok[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple (of names and Nones; ``()`` for a scalar), not
    a NamedTuple of such tuples."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") \
        and all(isinstance(e, (str, type(None))) for e in x)


def map_axes(fn, tree):
    """``fn`` over every logical-axes tuple of a tree of dicts, lists and
    (Named)Tuples."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_axes(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_axes(fn, v) for v in tree)
    raise TypeError(f"not a logical-axes tree node: {tree!r}")


def flatten_axes(tree) -> list:
    """The logical-axes tuples of a tree, in ``models.common.tree_flatten``
    order (dict keys sorted), so they line up with a parameter tree's
    leaves."""
    if is_axes_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flatten_axes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in flatten_axes(v)]
    raise TypeError(f"not a logical-axes tree node: {tree!r}")


def spec_tree(axes_tree, rules: AxisRules, mesh):
    """Map a tree of logical-axes tuples to a tree of specs."""
    return map_axes(lambda ax: logical_to_spec(ax, rules, mesh), axes_tree)


# ---------------------------------------------------------------------------
# placements: each rank's block of a leaf
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """A leaf's layout on a mesh (the counterpart of ``NamedSharding``):
    ``mesh`` is ((axis, size), ...) in mesh order, ``spec`` the leaf's
    spec.  Ranks are numbered in ``Mesh.devices.flat`` order (row-major
    over the mesh axes).  A dimension sharded over several axes is cut
    into blocks numbered major-to-minor in the spec's order, as
    ``NamedSharding`` numbers them."""

    mesh: Tuple[Tuple[str, int], ...]
    spec: Spec

    @classmethod
    def of(cls, mesh, spec: Spec) -> "Placement":
        sizes = _mesh_shape(mesh)
        return cls(tuple((a, sizes[a]) for a in mesh.axis_names), spec)

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dimension ``dim`` is sharded over (major first)."""
        return _as_axes(self.spec[dim]) if dim < len(self.spec) else ()

    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the leaf is sharded over, in mesh order."""
        used = {a for d in range(len(self.spec)) for a in self.dim_axes(d)}
        return tuple(a for a, _ in self.mesh if a in used)

    def count(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is cut into."""
        sizes = dict(self.mesh)
        n = 1
        for a in self.dim_axes(dim):
            n *= sizes[a]
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        out, stride = {}, 1
        for a, n in reversed(self.mesh):
            out[a] = (rank // stride) % n
            stride *= n
        return out

    def block(self, dim: int, rank: int) -> int:
        """Rank ``rank``'s block index along dimension ``dim``."""
        sizes, c, b = dict(self.mesh), self.coords(rank), 0
        for a in self.dim_axes(dim):
            b = b * sizes[a] + c[a]
        return b

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // self.count(d) for d, n in enumerate(shape))

    def index(self, shape: Sequence[int], rank: int) -> Tuple[slice, ...]:
        """The slices of the global leaf that rank ``rank`` holds (its entry
        of ``NamedSharding.devices_indices_map``)."""
        out = []
        for d, n in enumerate(shape):
            k = self.count(d)
            if n % k:
                raise ValueError(f"dimension {d} of size {n} does not split "
                                 f"into {k} blocks ({self.spec})")
            b = self.block(d, rank)
            out.append(slice(b * (n // k), (b + 1) * (n // k)))
        return tuple(out)


def param_shardings(axes_tree, rules: AxisRules, mesh):
    """Tree of Placements for a tree of logical-axes tuples (no
    divisibility guard, as the reference's)."""
    return map_axes(lambda ax: Placement.of(mesh, logical_to_spec(
        ax, rules, mesh)), axes_tree)


def shardings_for(shapes_tree, axes_tree, rules: AxisRules, mesh):
    """Placements with a per-dimension divisibility guard: a dim that does
    not divide by its mesh-axis product is replicated.  ``shapes_tree``
    holds tensors (any leaf with ``.shape``); the result has its
    structure, one Placement per leaf."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    sh_leaves, treedef = tree_flatten(shapes_tree)
    ax_leaves = flatten_axes(axes_tree)
    if len(sh_leaves) != len(ax_leaves):
        raise ValueError(f"shapes/axes mismatch: {len(sh_leaves)} vs "
                         f"{len(ax_leaves)}")

    def one(leaf, ax):
        shape = tuple(leaf.shape)
        axes = tuple(ax) + (None,) * (len(shape) - len(ax))
        return Placement.of(mesh, logical_to_spec(axes, rules, mesh, shape))
    return tree_unflatten(treedef, [one(s, a) for s, a
                                    in zip(sh_leaves, ax_leaves)])


def divisible_or_replicate(dim_size: int, logical: str, rules: AxisRules,
                           mesh) -> MeshAxes:
    """A dim's mesh axes when it divides by their product, else None."""
    mesh_axes = _as_axes(rules.mesh_axes_for(logical))
    if not mesh_axes:
        return None
    sizes = _mesh_shape(mesh)
    size = 1
    for a in mesh_axes:
        size *= sizes[a]
    return mesh_axes if dim_size % size == 0 else None


# ---------------------------------------------------------------------------
# the ambient process mesh
# ---------------------------------------------------------------------------

# The process's mesh: a process is one rank of one mesh, and autograd runs
# the backward (a remat group's recompute too) on a thread of its own on
# the card, so the ambient mesh is process-wide, not per thread.
_AMBIENT: list = []


def ambient_mesh():
    """The process mesh installed by ``with mesh:`` (None outside one)."""
    return _AMBIENT[-1] if _AMBIENT else None


def set_ambient_mesh(mesh):
    """Install ``mesh`` (None: none) as the ambient mesh until
    ``reset_ambient_mesh(token)``; ``ProcessMesh.__enter__``/``__exit__``
    call these."""
    _AMBIENT.append(mesh)
    return len(_AMBIENT)


def reset_ambient_mesh(token) -> None:
    if len(_AMBIENT) != token:
        raise RuntimeError("ambient meshes reset out of order")
    _AMBIENT.pop()


def world_of(mesh) -> int:
    n = 1
    for v in _mesh_shape(mesh).values():
        n *= v
    return n


def data_parallel_size(shard_cfg: ShardConfig,
                       mesh: Optional[Dict[str, int]] = None) -> int:
    """Total data-parallel world size: the ``data`` axis, times ``pod``
    when ``shard_cfg.pod_in_batch``.  ``mesh`` is an axis-name -> size
    dict (e.g. ``launch.mesh.make_production_mesh()``); without it the
    ambient process mesh is read, and 1 off a mesh."""
    if mesh is None:
        amb = ambient_mesh()
        if amb is None:
            return 1
        mesh = amb.shape
    dp = mesh.get("data", 1)
    if "pod" in mesh and shard_cfg.pod_in_batch:
        dp *= mesh["pod"]
    return dp


def batch_axes(shard_cfg: ShardConfig, mesh) -> Tuple[str, ...]:
    """The mesh axes the batch is split over (the resolved ``batch``
    rule, axes the mesh has)."""
    names = set(mesh.axis_names)
    return tuple(a for a in _as_axes(
        shard_cfg.resolve(mesh).mesh_axes_for("batch")) if a in names)


def axis_index(mesh, axes) -> int:
    """This rank's block index over ``axes`` (major first), as a
    ``Placement`` numbers the blocks of a dimension split over them."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def sequence_parallel_on(shard_cfg: ShardConfig, mesh,
                         seq_len: int) -> bool:
    """Whether the residual stream of a ``seq_len``-long sequence is split
    along the sequence over the model axis on ``mesh``: exactly where the
    reference's ``logical_to_spec`` gives ``("batch", "seq", "embed")``'s
    ``seq`` the model axis for that length (``sequence_parallel`` on, a
    model axis of more than one rank, and ``seq_len`` a multiple of it:
    its divisibility guard releases the axis otherwise, and the step is
    then the one without sequence parallelism).  False off a mesh."""
    if mesh is None:
        return False
    spec = logical_to_spec(("batch", "seq"), shard_cfg.resolve(mesh), mesh,
                           (None, seq_len))
    return len(spec) > 1 and _as_axes(spec[1]) == ("model",)


def seq_block(x, mesh, dim: int = 1):
    """This rank's block of ``x`` along the sequence (dimension ``dim``)
    over the model axis: a view, whose gradient is zero outside it."""
    n, i = mesh.shape["model"], mesh.coords["model"]
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def shard_activation(x, logical_axes, shard_cfg: ShardConfig,
                     seq_len: Optional[int] = None):
    """The reference's sharding constraint on an activation, by logical
    axes.  A rank holds its own slice of the batch by construction; where
    :func:`sequence_parallel_on` for the global ``seq_len``, the result is
    this rank's block of the sequence (``x`` itself when it is that block
    already, else its :func:`seq_block`).  On a mesh it checks that the
    rules ask for no other layout: an axis over the mesh other than the
    batch over its axes and the sequence over the model axis raises
    ``ValueError``."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    batch = set(batch_axes(shard_cfg, mesh))
    rules = shard_cfg.resolve(mesh)
    sp = seq_len is not None and sequence_parallel_on(shard_cfg, mesh,
                                                      seq_len)
    shape = [None] * len(logical_axes)
    if seq_len is not None and "seq" in logical_axes:
        shape[logical_axes.index("seq")] = seq_len
    for name, ax in zip(logical_axes, logical_to_spec(logical_axes, rules,
                                                      mesh, shape)):
        if ax is None or (name == "batch" and not set(_as_axes(ax)) - batch) \
                or (name == "seq" and sp):
            continue
        raise ValueError(f"activation axis {name!r} over {ax} is not "
                         f"implemented")
    if sp:
        dim = logical_axes.index("seq")
        if x.shape[dim] == seq_len:
            return seq_block(x, mesh, dim)
    return x


# logical axes that the FSDP placeholder resolves onto (weight shards that
# must be re-gathered before compute)
FSDP_TAGGED = ("qkv_in", "o_out", "ff_in", "expert_in", "ssm_in", "emb_embed")


def compute_rules(shard_cfg: ShardConfig, mesh) -> AxisRules:
    """The rules a weight is used under: FSDP-tagged dims replicated."""
    d = shard_cfg.resolve(mesh).to_dict()
    for name in FSDP_TAGGED:
        d[name] = None
    return AxisRules(tuple(d.items()))


def compute_range(logical_axes, shape, dim: int, shard_cfg: ShardConfig,
                  mesh=None) -> Optional[Tuple[int, int]]:
    """This rank's range [lo, hi) of dimension ``dim`` of a weight with
    global ``shape`` as it is used in compute (after
    ``gather_weights_for_compute``), or None when the dimension is whole
    on every rank (off a mesh, too)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return None
    spec = logical_to_spec(logical_axes, compute_rules(shard_cfg, mesh),
                           mesh, shape)
    pl = Placement.of(mesh, spec)
    if pl.count(dim) == 1:
        return None
    sl = pl.index(shape, mesh.rank)[dim]
    return sl.start, sl.stop


def gather_weights_for_compute(params, axes_tree, shard_cfg: ShardConfig,
                               shapes, grad_dtype: Optional[torch.dtype] = None):
    """ZeRO-3 just-in-time weight all-gather.

    FSDP stores weights sharded over the data axes; each leaf is gathered
    over the axes its storage spec has and its compute spec (FSDP-tagged
    dims replicated) has not, right before use.  The gather's backward
    reduce-scatters the weight gradient (summing over the axes the batch
    is split on, in ``grad_dtype``: the ``grad_allreduce_dtype`` knob;
    the gradient's own dtype when None).  ``shapes`` is a tree of the leaves' global shapes
    (tensors, e.g. ``Model.param_shapes()``' meta tensors), which the
    specs' divisibility guard reads.  Returns ``params`` off a mesh or
    with FSDP off."""
    mesh = ambient_mesh()
    if mesh is None or not shard_cfg.fsdp:
        return params
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.parallel import collectives
    rules = shard_cfg.resolve(mesh)
    crules = compute_rules(shard_cfg, mesh)
    summed = batch_axes(shard_cfg, mesh)
    p_leaves, treedef = tree_flatten(params)
    sh_leaves = tree_flatten(shapes)[0]
    ax_leaves = flatten_axes(axes_tree)
    if not len(p_leaves) == len(sh_leaves) == len(ax_leaves):
        raise ValueError("params, shapes and axes trees differ")
    out = []
    for leaf, sh, ax in zip(p_leaves, sh_leaves, ax_leaves):
        shape = tuple(sh.shape)
        axes = tuple(ax) + (None,) * (len(shape) - len(ax))
        store = Placement.of(mesh, logical_to_spec(axes, rules, mesh, shape))
        comp = Placement.of(mesh, logical_to_spec(axes, crules, mesh, shape))
        for d in range(len(shape)):
            extra = [a for a in store.dim_axes(d)
                     if a not in comp.dim_axes(d)]
            if tuple(a for a in store.dim_axes(d) if a not in extra) \
                    != comp.dim_axes(d):
                raise ValueError(f"compute spec {comp.spec} is not a "
                                 f"gather of storage spec {store.spec}")
            if extra:
                leaf = collectives.all_gather(leaf, d, tuple(extra), mesh,
                                              sum_axes=summed,
                                              grad_dtype=grad_dtype)
        out.append(leaf)
    return tree_unflatten(treedef, out)
