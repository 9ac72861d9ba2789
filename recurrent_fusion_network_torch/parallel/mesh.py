"""The meshes: the dp x mp rank grid and its collectives, and the
single-process device mesh.

Counterpart of ``recurrent_fusion_network_tpu/parallel/mesh.py``. There a
'dp' mesh (or a 2-D ('dp', 'mp') one) is one program over devices and
GSPMD inserts the collectives. Here each rank is a process
(``parallel/distributed.py``), laid out as JAX lays the devices out,
``reshape(dp, mp)``, and ``Mesh`` does what GSPMD does for it:

  replicate(params, opt_state)    rank 0's parameters and optimizer state
                                  broadcast once at the start
  all_reduce_grads(grads, loss)   the gradients and the loss summed over the
                                  rank's dp group in a few contiguous
                                  buckets, then scaled by 1 / dp (gloo has
                                  no ReduceOp.AVG); the identity at dp 1
  draws(generator)                the ``RowShard`` of the rank's dp index,
                                  so the dp ranks draw what one process
                                  draws and the mp ranks of one dp index
                                  draw alike

The loss is a mean over rows (sum / B) and the dp ranks hold equal shares
of the batch, so the mean of their gradients is the gradient of the global
batch, and the mean of their losses its loss.

With mp > 1 (``make_mesh_2d``, ``--num_mp_devices``) the vocabulary-wide
leaves are split over the mp ranks of a dp index as JAX
``shard_params_2d`` places them: logit ``w`` (R, V+1) by columns, logit
``b`` alike, ``embed`` (V+1, E) by rows; the optimizer moments of those
leaves with them (``shard_opt_state_2d``); everything else replicated.
``VocabParallel`` runs the embedding and the logit on the shards with the
collectives GSPMD inserts there: the embedding a masked local lookup summed
over the mp group, the logit a local matmul whose columns are gathered
over the group, so the log-softmax, label smoothing, scheduled sampling
and the criterion see the full (B, V+1) rows on every rank; the decoder
output entering the logit takes the mp sum of its gradient. The replicated
leaves' gradients are then the same on the mp ranks of a dp index, bit for
bit, and need no mp collective. ``gather_params_2d`` and
``gather_opt_state_2d`` rebuild the full trees (eval, checkpoints).

``DeviceMesh`` (``make_device_mesh``) is the JAX single-process 'dp'
mesh: a list of devices. ``with_dp_sharding`` splits a batch's rows into
one contiguous block a device, ``replicate`` puts a tree on every device,
and ``join_blocks`` concatenates the blocks' outputs in order on the host.
A device may appear more than once in the list (two blocks on one card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.cells import RowShard
from ..ops.initializers import tree_leaves, tree_map
from . import distributed

# elements per bucket (256 MB of f32): a few buckets at flagship width, and
# one bucket's worth of memory beside the gradients while they are summed
BUCKET_ELEMS = 1 << 26


def _buckets(tensors):
    """Index lists of ``tensors``, in order, each of one dtype and device
    and at most BUCKET_ELEMS elements (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        n = t.numel()
        if cur and (size + n > BUCKET_ELEMS or t.dtype != tensors[cur[0]].dtype
                    or t.device != tensors[cur[0]].device):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        out.append(cur)
    return out


# --------------------------------------------------------- mp collectives

# the integer type of each float width: gathers move bits, not values
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _all_reduce(t, vp) -> None:
    """Sum ``t`` over the mp group in place. gloo sums half-width floats
    in f32 (it may lack them), rounding once."""
    if vp.backend == "gloo" and t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, group=vp.group)
        t.copy_(wide)
    else:
        dist.all_reduce(t, group=vp.group)


def _all_gather(t, vp, dim: int):
    """The mp group's ``t`` concatenated along ``dim`` in rank order, bit
    for bit. NCCL gathers on the device; gloo, which has no all_gather of
    CUDA tensors, gathers the bits through host memory."""
    t = t.contiguous()
    if vp.backend == "nccl":
        out = torch.empty((vp.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=vp.group)
        return torch.cat(out.unbind(0), dim=dim)
    bits = t.view(_BITS[t.element_size()]).cpu() if t.is_floating_point() else t.cpu()
    parts = [torch.empty_like(bits) for _ in range(vp.size)]
    dist.all_gather(parts, bits, group=vp.group)
    return torch.cat(parts, dim=dim).to(t.device).view(t.dtype)


class _CopyToMp(torch.autograd.Function):
    """Identity forward; the mp sum of the gradient backward (the decoder
    output that enters the sharded logit)."""

    @staticmethod
    def forward(ctx, x, vp):
        ctx.vp = vp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g, ctx.vp)
        return g, None


class _GatherFromMp(torch.autograd.Function):
    """The logit shards gathered on the last axis forward; the rank's
    columns of the gradient backward."""

    @staticmethod
    def forward(ctx, x, vp):
        ctx.vp, ctx.cols = vp, x.shape[-1]
        return _all_gather(x, vp, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.vp.index * ctx.cols, ctx.cols).contiguous(), None


class _ReduceFromMp(torch.autograd.Function):
    """The mp sum forward; identity backward (the embedding's masked
    local lookups)."""

    @staticmethod
    def forward(ctx, x, vp):
        out = x.clone()
        _all_reduce(out, vp)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class VocabParallel:
    """One mp rank's share of the vocabulary: shard ``index`` of ``size``
    over ``group`` (of ``backend``). The models take it as their
    ``vocab_parallel`` and route the embedding and the logit through it."""

    def __init__(self, index: int, size: int, group, backend: str):
        self.index, self.size, self.group, self.backend = index, size, group, backend

    def embed(self, table, tokens):
        """Rows of the full table for ``tokens``, from this rank's rows
        ``table``: each token is looked up on the rank holding it and
        summed over the group (the others add zeros)."""
        n = table.shape[0]
        local = tokens - self.index * n
        inside = (local >= 0) & (local < n)
        rows = table[torch.where(inside, local, torch.zeros_like(local))]
        part = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))
        return _ReduceFromMp.apply(part, self)

    def logits(self, logits_fn, h):
        """``logits_fn(h)`` on this rank's columns, gathered to the full
        vocabulary (in ``logits_fn``'s dtype)."""
        return _GatherFromMp.apply(logits_fn(_CopyToMp.apply(h, self)), self)


# ------------------------------------------------------------ the rank grid


class Mesh:
    """One rank's view of the dp x mp grid (``distributed.initialize``): its
    rank among ``world``, its dp index among ``dp`` and mp index among
    ``mp``, and with mp > 1 its ``vocab`` share. The gradient collectives
    run on the rank's dp group (NCCL on CUDA, gloo on the CPU, or gloo
    where the caller named it)."""

    def __init__(self, cluster: distributed.Cluster):
        self.rank, self.world = cluster.rank, cluster.world
        self.dp, self.mp = cluster.dp, cluster.mp
        self.dp_index, self.mp_index = cluster.dp_index, cluster.mp_index
        self.dp_group = cluster.dp_group
        self.vocab = (VocabParallel(cluster.mp_index, cluster.mp, cluster.mp_group,
                                    cluster.backend) if cluster.mp > 1 else None)

    def draws(self, generator):
        """The dp index's share of ``generator``'s draws (the generator
        itself at dp 1)."""
        return generator if self.dp == 1 else RowShard(generator, self.dp_index, self.dp)

    def replicate(self, *trees) -> None:
        """Every tensor leaf of ``trees`` set to rank 0's, in place."""
        leaves = [x for tree in trees for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        for idx in _buckets(leaves):
            bucket = torch.cat([leaves[i].reshape(-1) for i in idx])
            dist.broadcast(bucket, src=0)
            for i, part in zip(idx, bucket.split([leaves[i].numel() for i in idx])):
                leaves[i].copy_(part.view_as(leaves[i]))

    def all_reduce_grads(self, grads: list, loss):
        """-> (grads, loss): the mean over the dp group of each gradient
        and of the loss, the loss carried in the last bucket (no collective
        of its own). ``grads`` is consumed: its entries are dropped bucket
        by bucket, so the summed copy is the only one held at the end."""
        if self.dp == 1:
            return grads, loss
        grads.append(loss.detach().reshape(1).to(torch.float32))
        shapes = [t.shape for t in grads]
        out = [None] * len(grads)
        for idx in _buckets(grads):
            bucket = torch.cat([grads[i].reshape(-1) for i in idx])
            for i in idx:
                grads[i] = None
            dist.all_reduce(bucket, group=self.dp_group)
            bucket.div_(self.dp)
            for i, part in zip(idx, bucket.split([shapes[i].numel() for i in idx])):
                out[i] = part.view(shapes[i])
        grads.clear()
        return out[:-1], out[-1].reshape(())


# the JAX CLIs' words where a dp x mp mesh does not apply (main.py:53-56,
# main_rl.py:26-29)
MP_FLEET = ("--num_mp_devices applies to solo XE runs; fleets (--n_seeds) shard the seed "
            "axis over dp instead")
MP_RL = ("--num_mp_devices is not supported by the RL loop; use it with main.py (solo XE) "
         "and run SCST on a dp mesh")


def _cluster_or_raise(what: str) -> distributed.Cluster:
    c = distributed.cluster()
    if c is None:
        raise RuntimeError(f"{what} needs a process group: call "
                           "parallel.distributed.initialize() first")
    return c


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The data-parallel descriptor of the group ``distributed.initialize``
    joined with mp 1; ``n_devices`` (``--num_dp_devices``), where given,
    must be its size. ValueError for a group laid out with mp > 1."""
    c = _cluster_or_raise("make_mesh")
    if n_devices is not None and n_devices != c.world:
        raise ValueError(f"--num_dp_devices {n_devices}, but the process group has "
                         f"{c.world} rank(s)")
    if c.mp != 1:
        raise ValueError(f"the process group is laid out dp x mp with mp {c.mp}; "
                         "make_mesh is its dp-only view (mp 1)")
    return Mesh(c)


def make_mesh_2d(dp: int, mp: int) -> Mesh:
    """The dp x mp grid of the group (JAX ``make_mesh_2d``): the world must
    be dp * mp ranks, laid out with this ``mp`` by ``distributed.initialize``
    (ValueError otherwise)."""
    c = _cluster_or_raise("make_mesh_2d")
    if dp < 1 or mp < 1 or dp * mp != c.world:
        raise ValueError(f"a {dp} x {mp} (dp x mp) mesh needs {dp * mp} rank(s); the "
                         f"process group has {c.world}")
    if c.mp != mp:
        raise ValueError(f"a {dp} x {mp} (dp x mp) mesh, but the process group is laid out "
                         f"with mp {c.mp}: pass mp={mp} to distributed.initialize")
    return Mesh(c)


def is_mesh_2d(mesh) -> bool:
    """True when the mesh carries a non-trivial 'mp' axis."""
    return mesh is not None and getattr(mesh, "mp", 1) > 1


# the sharded leaves: top-level key -> axis of the vocabulary
_SHARDED = {"embed": 0, "logit": -1}


def _vocab_split(params) -> bool:
    return isinstance(params, dict) and "logit" in params and "embed" in params


def _shard(x, axis: int, index: int, size: int):
    width = x.shape[axis]
    if width % size:
        raise ValueError(f"the vocabulary axis ({width} = V + 1) does not divide by the "
                         f"{size} mp ranks")
    n = width // size
    return x.narrow(axis, index * n, n).clone()


def shard_params_2d(mesh, params):
    """This mp rank's shard of ``params`` (JAX ``shard_params_2d``): logit
    ``w`` (R, V+1) -> columns ``[m (V+1)/mp, (m+1) (V+1)/mp)``, logit ``b``
    the same entries, ``embed`` (V+1, E) the same rows, as own tensors;
    every other leaf as it is (replicated). ValueError where V + 1 does not
    divide by mp."""
    if not _vocab_split(params):
        return params
    out = dict(params)
    for key, axis in _SHARDED.items():
        out[key] = tree_map(lambda x: _shard(x, axis, mesh.mp_index, mesh.mp), params[key])
    return out


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _map_state(opt_state, params_template, fn):
    """``fn`` on every params-shaped field of an optimizer state (the
    moments); counts and absent fields as they are."""
    shape = _structure(params_template)
    return type(opt_state)(*(fn(f) if isinstance(f, dict) and _structure(f) == shape else f
                             for f in opt_state))


def shard_opt_state_2d(mesh, opt_state, params_template, sharded_params=None):
    """The optimizer state with every params-shaped subtree (the moments)
    sharded as its weights (JAX ``shard_opt_state_2d``); counts as they
    are. ``sharded_params`` is accepted for the JAX signature."""
    return _map_state(opt_state, params_template, lambda f: shard_params_2d(mesh, f))


def gather_params_2d(mesh, params):
    """The full tree of a ``shard_params_2d`` shard: the vocabulary leaves
    gathered over the mp group (collective), the rest as they are. The
    inverse of ``shard_params_2d``, bit for bit."""
    if not _vocab_split(params):
        return params
    out = dict(params)
    for key, axis in _SHARDED.items():
        out[key] = tree_map(lambda x: _all_gather(x, mesh.vocab, axis % x.dim()), params[key])
    return out


def gather_opt_state_2d(mesh, opt_state, params_template):
    """The full optimizer state of a ``shard_opt_state_2d`` shard."""
    return _map_state(opt_state, params_template, lambda f: gather_params_2d(mesh, f))


# ------------------------------------------------- the single-process mesh


class DeviceMesh:
    """A single-process 'dp' mesh (JAX ``make_mesh``): the devices in
    order, block k of every batch's rows on ``devices[k]``."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"dp": len(self.devices)}

    @property
    def dp(self) -> int:
        return len(self.devices)


def visible_devices(device=None) -> list:
    """The devices a CLI's mesh is made of: the visible CUDA cards, or the
    CPU (one) where ``device`` is "cpu"."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_mesh(n_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """A 'dp' mesh over the first ``n_devices`` of ``devices`` (default:
    the visible CUDA cards); ValueError where there are fewer."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a device mesh needs at least one device")
    return DeviceMesh(devs)


def _to(x, device):
    """A host tensor to ``device`` without blocking on a CUDA card (from
    page-locked memory, so it queues behind the work in flight)."""
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def with_dp_sharding(mesh: DeviceMesh, tree) -> list:
    """One tree a device: every leaf's leading axis in ``mesh.dp`` equal
    contiguous blocks, block k on ``mesh.devices[k]``. ValueError where a
    leading axis does not divide by dp."""

    for x in tree_leaves(tree):
        if x.shape[0] % mesh.dp:
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide by the mesh's "
                             f"{mesh.dp} devices")

    def block(x, k, device):
        n = x.shape[0] // mesh.dp
        return _to(x.narrow(0, k * n, n), device)

    return [tree_map(lambda x, k=k, d=d: block(x, k, d), tree)
            for k, d in enumerate(mesh.devices)]


def replicate(mesh: DeviceMesh, tree) -> list:
    """``tree`` on every device of the mesh, one tree a device (a device
    holding the tree already shares it)."""
    return [tree_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices]


def join_blocks(blocks: Sequence):
    """The blocks' output trees as one, every tensor leaf concatenated
    along its leading axis on the host in block order (the one readback);
    named tuples, dicts, lists and None leaves keep their places."""
    first = blocks[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([b.cpu() for b in blocks])
    if isinstance(first, dict):
        return {k: join_blocks([b[k] for b in blocks]) for k in first}
    fields = [join_blocks([b[i] for b in blocks]) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else type(first)(fields)
