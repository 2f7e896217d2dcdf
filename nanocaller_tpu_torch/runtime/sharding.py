"""Data parallelism for inference and the sharded SNP train step (the
counterpart of nanocaller_tpu/runtime/sharding.py).

Inference: candidate batches split over the process's cards while the
small CNNs are replicated — the multi-card analog of the reference's N
CPU inference workers (snpCaller.py:213-245): the devices, the
per-device batch and the split of a batch's rows over replicas.

Training: a (dp, mdl) grid of processes, one a rank (make_mesh). The
batch splits over dp; the wide dense layers are tensor-parallel over
mdl (snp_param_shardings): each mdl rank holds a slice of fc1's output
rows and of fa's and fc2's input columns. Where JAX's XLA inserts the
collectives from the sharding annotations alone, here they are written
out (shard_train_step): the partial fa/fc2 products are summed over mdl
in the forward, the gradient into fc1's input (and so into the whole
conv trunk) is summed over mdl in the backward, and the gradients are
averaged over dp. NCCL carries them between cards, Gloo between CPU
processes.
"""

from __future__ import annotations

import copy
import datetime
import math
import queue
import socket
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .device import resolve_device


def inference_devices(device="cuda"):
    """The process's cards for in-process data parallelism; None when
    there are fewer than two (the counterpart of inference_mesh).

    Used by SnpCallerState / IndelCallerState when `devices="auto"`. A
    bare "cuda" takes every visible card; an explicit "cuda:k" (what
    each process of a multi-process run gets, caller.run) and the CPU
    are one device: under multi-process runs each process holds its own
    region shard on its own card, and in-process DP over local cards
    composes with that sharding."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def dp_scale(batch_size, devices):
    """Global batch for a PER-DEVICE batch size.

    cfg.batch_size is the per-device batch: with n replicas the global
    batch is n× that, so every replica runs the same (batch_size, ...)
    forward a single device would — which makes multi-device inference
    bit-identical to single-device by construction
    (tests/test_torch_distributed.py pins this down)."""
    return batch_size * len(devices) if devices else batch_size


def dp_rows(n_rows, batch_size, devices):
    """Each replica's rows of an n_rows batch, in order.

    The rows go in global batches of dp_scale(batch_size, devices) rows,
    each cut into consecutive batch_size slices, slice j to replica j.
    A replica's rows are thus whole batch_size slices of the
    single-device run (the last one may be short), and its forward in
    batch_size rows computes exactly what one device computes on them.
    One device: [arange(n_rows)]."""
    n = len(devices) if devices else 1
    slot = (np.arange(n_rows) % dp_scale(batch_size, devices)) // batch_size
    return [np.flatnonzero(slot == j) for j in range(n)]


def replicas(device, devices, *modules):
    """[(its device, *modules)] of each replica, for modules that lie on
    `device`.

    devices: the replicas' devices ("auto": inference_devices(device);
    None: `device` alone). A module goes to each replica as itself where
    it already lies and as a copy elsewhere (weights replicated)."""
    if devices == "auto":
        devices = inference_devices(device)
    if not devices:
        return [(device, *modules)]
    devs = [resolve_device(d) for d in devices]
    homes = [next(m.parameters()).device for m in modules]
    return [(d, *(m if d == home else copy.deepcopy(m).to(d)
                  for m, home in zip(modules, homes))) for d in devs]


@dataclass(frozen=True)
class Mesh:
    """A (dp, mdl) grid of process ranks: rank r at row r // mdl (its dp
    index) and column r % mdl (its mdl index), as JAX's make_mesh
    reshapes its devices."""

    dp: int
    mdl: int

    @property
    def world(self):
        return self.dp * self.mdl

    @property
    def shape(self):
        return {"dp": self.dp, "mdl": self.mdl}

    @property
    def grid(self):
        return np.arange(self.world).reshape(self.dp, self.mdl)

    def coords(self, rank):
        """(dp index, mdl index) of a rank."""
        return divmod(rank, self.mdl)


def make_mesh(world, dp=None):
    """The (dp, mdl) grid of `world` ranks. dp defaults as JAX's does:
    every rank on dp when world is odd, else a 2-way mdl axis
    (dp = world // 2); mdl = world // dp (ranks past dp × mdl idle)."""
    if world < 1:
        raise ValueError("a mesh needs at least one rank, got %d" % world)
    if dp is None:
        dp = world if world % 2 else world // 2
    return Mesh(dp, world // dp)


# the SNP model's tensor-parallel layout in torch's (out, in) layout:
# fc1's output rows (weight and bias) and fa's and fc2's input columns
# split over mdl; every other parameter replicated
_SNP_TP_AXES = {"fc1.weight": 0, "fc1.bias": 0, "fa.weight": 1,
                "fc2.weight": 1}


def snp_param_shardings(mesh, state_dict):
    """{name: the axis split over mdl, or None for a replicated one} for
    each SNP parameter of state_dict (the counterpart of JAX's
    PartitionSpecs: fc1's kernel P(None, "mdl") is the weight's axis 0
    here, fa's and fc2's P("mdl", None) the weight's axis 1). A split
    axis must divide by mdl."""
    out = {}
    for name, val in state_dict.items():
        axis = _SNP_TP_AXES.get(name)
        if axis is not None and val.shape[axis] % mesh.mdl:
            raise ValueError("%s axis %d (%d) does not split %d ways"
                             % (name, axis, val.shape[axis], mesh.mdl))
        out[name] = axis
    return out


def local_shard(mesh, rank, value, axis):
    """Rank's slice of a value split over mdl along axis (all of it when
    axis is None)."""
    if axis is None:
        return value
    _d, m = mesh.coords(rank)
    n = value.shape[axis] // mesh.mdl
    return value[(slice(None),) * axis + (slice(m * n, (m + 1) * n),)]


def _all_reduce(x, group):
    y = x.detach().reshape(-1).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.reshape(x.shape)


class _SumOverMdl(torch.autograd.Function):
    """(a) The partial products of a layer split on its input axis, summed
    over mdl in the forward; each rank's gradient is already the whole
    one, so the backward passes it on unchanged. Without it the layer's
    output is one rank's share."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGradOverMdl(torch.autograd.Function):
    """(b) fc1's input, replicated over mdl: the identity in the forward,
    and in the backward the sum over mdl of the ranks' partial gradients
    (each rank's flows through its own slice of fc1's rows only). Without
    it every gradient of the conv trunk comes out short, by the mdl
    factor where the slices contribute alike, with no error."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def _tensor_parallel_snp(mdl, group):
    """An SNPModel whose fc1, fa and fc2 run on a rank's slices (set by
    the caller) with the collectives (a) and (b) over the mdl `group`.
    With mdl = 1 every layer computes as SNPModel's does, bit for bit."""
    from ..models import SNPModel

    class TensorParallelSNP(SNPModel):
        def dense(self, layer, x):
            if layer is self.fc1:
                return F.linear(_SumGradOverMdl.apply(x, group),
                                layer.weight, layer.bias)
            whole = mdl == 1
            y = _SumOverMdl.apply(
                F.linear(x, layer.weight, layer.bias if whole else None),
                group)
            return y if whole else y + layer.bias

    return TensorParallelSNP()


def _tp_kernel_l2(model, shardings, group):
    """snp_train.kernel_l2 with the split weights' terms summed over mdl
    (so the loss holds the whole ½Σw², while each slice's gradient stays
    its own)."""
    reg = 0.0
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            term = (p * p).sum() / 2
            if shardings[name] is not None:
                term = _SumOverMdl.apply(term, group)
            reg = reg + term
    return reg


def shard_train_step(mesh, rank, state_dict, batch, lr=1e-3, device="cuda"):
    """One SNP train step (snp_train's loss, then Adam) as rank `rank` of
    `mesh`, in a process that has joined the process group of mesh.world
    ranks. state_dict: the whole initial weights (numpy, torch layout);
    batch: the whole batch (numpy dict, rows divisible by dp). The rank
    takes its dp block of rows and its mdl slices of the weights;
    gradients are averaged over dp after the backward, so every rank's
    Adam state is the slice of the unsharded one (Adam is elementwise).

    Returns (loss, grads, params): the whole batch's loss (a float, as
    the unsharded step reports it), the rank's gradients after the dp
    average and its weights after the update ({name: numpy array}, its
    slices for the split names)."""
    from ..train.snp_train import L2_GAMMA, snp_cost, to_device

    dev = resolve_device(device)
    d, m = mesh.coords(rank)
    B = len(batch["x"])
    if B % mesh.dp:
        raise ValueError("a batch of %d rows does not split %d ways"
                         % (B, mesh.dp))
    # every rank creates every group, in the same order
    dp_groups = [dist.new_group([int(r) for r in mesh.grid[:, j]])
                 for j in range(mesh.mdl)]
    mdl_groups = [dist.new_group([int(r) for r in mesh.grid[i, :]])
                  for i in range(mesh.dp)]
    dp_group, mdl_group = dp_groups[m], mdl_groups[d]

    shardings = snp_param_shardings(mesh, state_dict)
    model = _tensor_parallel_snp(mesh.mdl, mdl_group)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state_dict.items()})
    for name, axis in shardings.items():
        if axis is not None:
            layer, var = name.rsplit(".", 1)
            setattr(getattr(model, layer), var, torch.nn.Parameter(
                local_shard(mesh, rank, getattr(getattr(model, layer),
                                                var).detach(), axis)
                .clone()))
    model.to(dev)
    rows = slice(d * B // mesh.dp, (d + 1) * B // mesh.dp)
    local = to_device({k: v[rows] for k, v in batch.items()}, dev)

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    opt.zero_grad(set_to_none=True)
    loss = snp_cost(model, local) + L2_GAMMA * _tp_kernel_l2(
        model, shardings, mdl_group)
    loss.backward()
    for p in model.parameters():
        dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=dp_group)
        p.grad.div_(mesh.dp)
    opt.step()
    whole = _all_reduce(loss, dp_group) / mesh.dp
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}
    params = {n: p.detach().cpu().numpy()
              for n, p in model.named_parameters()}
    return float(whole), grads, params


def demo_state(seed=0):
    """The SNP model's weights as flax would initialise them
    (models.weights.init_params from `seed`), as {name: numpy array}."""
    from ..models import SNPModel, init_params

    model = init_params(SNPModel(), torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def demo_batch(mesh, seed=0):
    """The JAX demo's random SNP batch (max(8, dp) × 2 rows)."""
    rng = np.random.default_rng(seed)
    B = max(8, mesh.dp) * 2
    return {
        "x": rng.normal(size=(B, 5, 41, 5)).astype(np.float32),
        "ref": np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)],
        "base_labels": np.eye(2, dtype=np.float32)[
            rng.integers(0, 2, (B, 4))],
        "gt_label": np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)],
    }


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(results, mesh, rank, port, backend, device, state_dict,
               batch, lr, threads):
    """One rank's process of shard_train_step_demo: join the group, run
    the step, put (rank, error or None, result) on `results`. A CPU rank
    takes the caller's count of intra-op threads (the CPU kernels split
    their sums by it, so one rank then computes the caller's bits)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method="tcp://localhost:%d" % port, rank=rank,
            world_size=mesh.world, timeout=datetime.timedelta(minutes=10))
        try:
            out = shard_train_step(mesh, rank, state_dict, batch, lr, dev)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))


def shard_train_step_demo(world, dp=None, device="cuda", state_dict=None,
                          batch=None, lr=1e-3, timeout=600):
    """One sharded SNP train step over make_mesh(world, dp): `world`
    spawned processes, one a rank, joined by NCCL on "cuda" (rank r on
    card r mod the visible cards) or Gloo on "cpu" — never the one in
    place of the other; "cuda" without a GPU raises. state_dict and
    batch default to demo_state() and demo_batch(mesh).

    Returns {"mesh", "loss", "grads", "params"}: the loss, and the
    gradients and updated weights gathered whole ({name: numpy array},
    the split names' slices joined in mdl order from dp row 0). Raises
    when a rank fails, or when the dp rows disagree (a missed dp
    average) or the ranks report different losses."""
    dev = resolve_device(device)
    mesh = make_mesh(world, dp)
    if state_dict is None:
        state_dict = demo_state()
    if batch is None:
        batch = demo_batch(mesh)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        results, mesh, r, port, backend, dev.type, state_dict, batch, lr,
        torch.get_num_threads()))
        for r in range(mesh.world)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:  # drain before joining
            rank, err, out = results.get(timeout=timeout)
            if err is not None:
                raise RuntimeError("rank %d of the sharded step failed:\n%s"
                                   % (rank, err))
            outs[rank] = out
    except queue.Empty:
        raise RuntimeError("the sharded step's ranks gave no result in "
                           "%d s" % timeout) from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    losses = {outs[r][0] for r in outs}
    if len(losses) != 1:
        raise RuntimeError("the ranks report different losses: %s"
                           % sorted(losses))
    shardings = snp_param_shardings(mesh, state_dict)

    def gather(k, row):
        return {n: np.concatenate(
            [outs[int(r)][k][n] for r in mesh.grid[row]], axis=axis)
            if axis is not None else outs[int(mesh.grid[row, 0])][k][n]
            for n, axis in shardings.items()}

    grads, params = gather(1, 0), gather(2, 0)
    for row in range(1, mesh.dp):
        other = gather(1, row)
        if any(not np.array_equal(other[n], grads[n]) for n in grads):
            raise RuntimeError("dp row %d's gradients differ from row 0's"
                               % row)
    return {"mesh": mesh, "loss": losses.pop(), "grads": grads,
            "params": params}


def dp_devices(device, n):
    """n data-parallel replicas' devices: the cards in turn for a bare
    "cuda" (cuda:i mod the visible cards), else n times the device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i % torch.cuda.device_count())
                for i in range(n)]
    return [dev] * n


def shard_inference_demo(mesh, device="cuda", B=None):
    """The SNP inference path with candidate rows split over the mesh's
    dp replicas and replicated weights (the serving layout for
    region-sharded multi-card calling): one random dense batch of B rows
    (max(8, 2 dp) by default, R = 32 reads) through K5 and the SNP CNN
    (ONT-HG002 pack) on each replica's rows, at a per-device batch of
    ceil(B / dp) rows. Returns the (B, 4) probabilities."""
    from ..models import SNPModel, load_model, torch_state_dict_from_params
    from ..pileup.snp_dense import snp_dense_pileup
    from ..sim import random_dense_batch

    dev = resolve_device(device)
    B = B or max(8, 2 * mesh.dp)
    arrays = random_dense_batch(np.random.default_rng(0), B, 32)
    params, _ = load_model("snp", "ONT-HG002")
    model = SNPModel()
    model.load_state_dict(torch_state_dict_from_params(params))
    model.to(dev).eval()
    devices = dp_devices(dev, mesh.dp)
    probs = np.zeros((B, 4), np.float32)
    with torch.inference_mode():
        for (d, m), rows in zip(replicas(dev, devices, model),
                                dp_rows(B, math.ceil(B / mesh.dp), devices)):
            if not len(rows):
                continue
            x, ref = snp_dense_pileup(*(torch.from_numpy(
                np.ascontiguousarray(a[rows])).to(d) for a in arrays))
            probs[rows] = m(x, ref)[0][:, :, 1].cpu().numpy()
    return probs
