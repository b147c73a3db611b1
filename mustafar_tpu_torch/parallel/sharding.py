"""Tensor, data and expert parallelism over a ``("data", "model")`` device
mesh: port of ``mustafar_tpu/parallel/sharding.py``.

The JAX package runs one program over a global mesh and lets GSPMD insert
the collectives from its PartitionSpecs.  Here one process runs each rank
(SPMD): a rank holds its own shard of the params and its own slots' cache,
runs the single-device model on them with a *local* ``ModelConfig``
(``num_heads``, ``num_kv_heads`` and the dense MLP's ``intermediate_size``
over tp; ``head_dim`` kept, so the kernels see shapes they already take),
and reduces over the mesh explicitly where GSPMD would:

  * "model" (TP, Megatron-style): ``wq``, ``wk``, ``wv``, ``w_gate`` and
    ``w_up`` are column-parallel (each rank its share of the output heads
    and channels, with their scales); ``wo`` and ``w_down`` row-parallel
    (its share of the input rows; W8 scales replicated, W4 block scales cut
    with their rows, so a cut falls on a 128-row block edge), each followed
    by one ``all_reduce(SUM)`` (``ModelShard.sum_``); under W8A8 the row
    amax of their input is first reduced with MAX and the int32
    accumulators are summed, so the codes and sums are the single-device
    ones.  Mixtral's experts ``we_*`` are cut on the expert axis (EP): a
    rank runs its experts' capacity slots from the replicated router, and
    the partial combines are summed.  The LM head is cut on the vocabulary;
    the full logits are gathered by a zero-padded ``all_reduce(SUM)``
    (exact: every other term is 0).  The embedding, the norms, the router
    and the W8A8 markers are replicated; a tied head is the replicated
    ``embed.T`` and is not cut.
  * "data" (DP): the engine's slots, B/dp a rank; the caches hold B/dp
    slots of Hkv/tp kv heads.  Attention is head-local, so no collective
    runs inside it (the JAX package's ``shard_headlocal_attend``): the
    CUDA kernels run unchanged on a rank's shard.

``make_mesh`` builds the mesh over an initialized default process group;
the caller names the backend (``nccl`` with one card a rank, ``gloo`` on
the CPU or for ranks that share a card).  Its groups carry a timeout, so a
lost peer fails a collective instead of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from mustafar_tpu_torch.config import EngineConfig, ModelConfig

MESH_AXES = ("data", "model")

# layer leaves by how "model" cuts them (the stacked [L, ...] leaf's axis)
COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")        # out-channels: axis -1
ROW = ("wo", "w_down")                               # in-rows: axis -2
EXPERT = ("we_gate", "we_up", "we_down")             # experts: axis 1
REPLICATED = ("attn_norm", "mlp_norm", "w_router", "a8")
# the fused layouts of quant.fuse_projections: their parts, in order
FUSED = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up")}
TOP_REPLICATED = ("embed", "embed_scale", "final_norm", "act_quant")
W4_BLOCK = 128
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def make_mesh(dp: int, tp: int, device_type: str = "cuda",
              timeout: datetime.timedelta = GROUP_TIMEOUT, axes: tuple = MESH_AXES):
    """A ``DeviceMesh`` of shape (dp, tp) named ``axes`` (("data", "model");
    ("stage", "model") for the pipeline, ``pipeline.STAGE_AXES``) over the
    initialized default group (world size dp * tp; rank r is index r // tp
    on the first axis, model index r % tp).  Every rank must call it; a
    collective of its sub-groups raises after ``timeout``."""
    from torch.distributed.device_mesh import DeviceMesh

    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, the group has {world}")
    grid = torch.arange(world).view(dp, tp)
    mine = []
    # every rank creates every group, in the same order
    for dim in (0, 1):
        for ranks in (grid.T if dim == 0 else grid).tolist():
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine.append(g)
    return DeviceMesh.from_group(mine, device_type, mesh=grid, mesh_dim_names=tuple(axes))


def mesh_dims(mesh) -> tuple[int, int]:
    """(dp, tp) of a mesh (1, 1 for None)."""
    if mesh is None:
        return 1, 1
    return mesh.size(0), mesh.size(1)


def shard_bounds(n: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of rank's contiguous share of n (the first n % size ranks
    take one more), as ``torch.tensor_split`` cuts."""
    q, r = divmod(n, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` in place; returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """The "model" axis as one rank sees it: the reductions the model runs
    after a row-parallel projection, the expert combine and the LM head.
    ``data`` (the "data" group, this rank's index and its size) is set
    where the batch a call runs is spread over "data", every data group
    calling together: the MoE then routes the whole batch (``batch_rows``),
    as one device does.  None where one data group runs alone (the
    engine's batch-1 prefill)."""
    group: object
    rank: int
    size: int
    data: tuple | None = None

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM in place (f32 or integer tensors; a bf16 one is
        summed in f32 and rounded once).  Returns the result."""
        if self.size == 1:
            return x
        if x.dtype in (torch.bfloat16, torch.float16):
            return x.copy_(all_reduce(x.to(torch.float32), self.group))
        return all_reduce(x, self.group)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            all_reduce(x, self.group, dist.ReduceOp.MAX)
        return x

    def gather_last(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """A rank's share of the last axis (``shard_bounds`` of n) -> the
        whole [..., n] on every rank (``gather``)."""
        if self.size == 1:
            return local
        lo, _ = shard_bounds(n, self.size, self.rank)
        return gather(local, n, lo, -1, self.group)

    def batch_rows(self, local: torch.Tensor) -> tuple[torch.Tensor, int]:
        """This data group's rows [N, ...] of a batch spread over "data" ->
        (the whole batch's rows [N x dp, ...], this group's first row);
        (local, 0) where ``data`` is None.  Exact in any dtype."""
        if self.data is None:
            return local, 0
        group, index, size = self.data
        n = local.shape[0]
        whole = gather(local.to(torch.float32), n * size, index * n, 0, group)
        return whole.to(local.dtype), index * n


def gather(local: torch.Tensor, n: int, lo: int, dim: int, group) -> torch.Tensor:
    """A rank's rows [lo, lo + len) of axis ``dim`` -> all n of them on
    every rank of ``group``: a zero-padded all-reduce, exact (each element
    is one rank's plus zeros; gloo lists no all_gather on CUDA tensors)."""
    shape = list(local.shape)
    shape[dim] = n
    full = local.new_zeros(shape)
    full.narrow(dim, lo, local.shape[dim]).copy_(local)
    return all_reduce(full, group)


def model_shard(mesh, whole_batch: bool = True) -> ModelShard | None:
    """The rank's ``ModelShard`` of ``mesh`` (None for no mesh).
    ``whole_batch``: the calls it serves run every data group together on
    its share of one batch (``ModelShard.data``)."""
    if mesh is None:
        return None
    data = None
    if whole_batch and mesh.size(0) > 1 and mesh.mesh_dim_names[0] == "data":
        data = (mesh.get_group("data"), mesh.get_local_rank("data"), mesh.size(0))
    return ModelShard(mesh.get_group("model"), mesh.get_local_rank("model"), mesh.size(1),
                      data)


def local_model(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config a rank runs: heads, kv heads and the dense MLP's
    intermediate size over ``tp`` (head_dim, so G = Hq/Hkv, kept; a MoE
    keeps its global ``num_experts``, which sizes each expert's capacity,
    and holds num_experts/tp of them).  Refuses what the JAX plan cannot
    shard evenly: tp must divide the kv heads, the intermediate size or
    the experts."""
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp {tp} must divide num_kv_heads {cfg.num_kv_heads}")
    if cfg.num_experts:
        if cfg.num_experts % tp:
            raise ValueError(f"tp {tp} must divide num_experts {cfg.num_experts}")
        inter = cfg.intermediate_size
    else:
        if cfg.intermediate_size % tp:
            raise ValueError(f"tp {tp} must divide intermediate_size "
                             f"{cfg.intermediate_size}")
        inter = cfg.intermediate_size // tp
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=inter)


def local_engine(engine: EngineConfig, dp: int, tp: int) -> EngineConfig:
    """The engine config of a rank: ``local_model`` and batch_size / dp
    slots (dp must divide the slots, as the JAX engine asserts)."""
    if engine.batch_size % dp:
        raise ValueError(f"dp {dp} must divide the {engine.batch_size} slots")
    return dataclasses.replace(engine, model=local_model(engine.model, tp),
                               batch_size=engine.batch_size // dp)


def param_plan(name: str, leaf: torch.Tensor, layer: bool) -> int | None:
    """The axis "model" cuts a leaf on (None: replicated).  ``layer``: a
    leaf of ``params["layers"]`` (stacked on axis 0)."""
    if not layer:
        if name in ("lm_head", "lm_head_scale"):
            return -1
        if name in TOP_REPLICATED:
            return None
        raise ValueError(f"no sharding rule for params[{name!r}]")
    base = name[:-len("_scale")] if name.endswith("_scale") else name
    if base in COLUMN:
        return -1
    if base in ROW:
        if name == base:
            return -2
        # W8 per-out scales [L, out] follow the reduced output: replicated;
        # W4 block scales [L, in/128, out] follow their rows
        return -2 if leaf.dim() == 3 else None
    if base in EXPERT:
        return 1
    if name in REPLICATED:
        return None
    raise ValueError(f"no sharding rule for params['layers'][{name!r}]")


def _col_major(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1


def _layout_like(src: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t as a compact copy, column-major in its last two axes where ``src``
    is (``quant.enable_act_quant``'s int8 weights)."""
    if _col_major(src):
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)
    return t.contiguous()


def _cut(leaf: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """leaf[lo:hi] on ``axis``, a compact copy in leaf's layout."""
    return _layout_like(leaf, leaf.narrow(axis, lo, hi - lo))


def _cut_layer_leaf(name: str, leaf: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    axis = param_plan(name, leaf, layer=True)
    if axis is None or tp == 1:
        return leaf
    n = leaf.shape[axis]
    if leaf.dtype == torch.int16 and axis == -2:
        # W4 carriers [L, in/4, out]: block-local nibbles, 32 rows a block
        if (n * 4) % (tp * W4_BLOCK):
            raise ValueError(f"W4 {name}: a row-parallel cut of {n * 4} input rows "
                             f"over tp {tp} must fall on a {W4_BLOCK}-row block edge")
    elif n % tp:
        raise ValueError(f"{name}: axis {axis} of {tuple(leaf.shape)} over tp {tp}")
    step = n // tp
    return _cut(leaf, axis, rank * step, (rank + 1) * step)


def shard_params(cfg: ModelConfig, params: dict, tp: int, rank: int) -> dict:
    """Rank ``rank``'s shard (of ``tp`` on "model") of the full params dict:
    the port's ``filter_specs_for(param_specs)`` plus the cut.  Fused
    ``wqkv`` / ``w_gateup`` (``quant.fuse_projections``) are split into
    their parts, each part cut, and re-fused, so a rank's fused leaf is
    [its q | its k | its v].  Replicated leaves are shared, not copied."""
    layers = dict(params["layers"])
    split = {"wqkv": [cfg.q_dim, cfg.kv_dim, cfg.kv_dim],
             "w_gateup": [cfg.intermediate_size] * 2}
    fused = {}
    for fname, parts in FUSED.items():
        if fname not in layers:
            continue
        fused[fname] = parts
        for suffix in ("", "_scale"):
            if fname + suffix in layers:
                for part, piece in zip(parts, layers.pop(fname + suffix).split(
                        split[fname], dim=-1)):
                    layers[part + suffix] = piece
    out_layers = {k: _cut_layer_leaf(k, v, tp, rank) for k, v in layers.items()}
    for fname, parts in fused.items():
        for suffix in ("", "_scale"):
            if parts[0] + suffix in out_layers:
                cat = torch.cat([out_layers.pop(p + suffix) for p in parts], dim=-1)
                out_layers[fname + suffix] = _layout_like(params["layers"][fname + suffix],
                                                          cat)
    out = {"layers": out_layers}
    for k, v in params.items():
        if k == "layers":
            continue
        axis = param_plan(k, v, layer=False)
        if axis is None or tp == 1:
            out[k] = v
        else:
            lo, hi = shard_bounds(v.shape[axis], tp, rank)
            out[k] = _cut(v, axis, lo, hi)
    return out
