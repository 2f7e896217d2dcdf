"""SNP calling: pileups on the device (kernels K3 and K5) + CNN +
genotype decode + VCF output.

The SNP stage of nanocaller_tpu/snp_caller.py, with the same semantics:
coverage normalization (snpCaller.py:93-96), the per-base-probability
genotype decision tree (:113-163), haploid decode (:166-198), Phred
formulas incl. the haploid ×100 scale (:192), VCF text formats byte for
byte, and the two-file output contract ({prefix}.unfiltered.snps.vcf.gz
+ PASS-only {prefix}.snps.vcf.gz).

The host builds the observation payloads (pileup/snp_features.py) and
this process turns them into pileups on the state's device, by one of
three paths, as the JAX package's payload types choose them:
- a decode group's SnpGroupFeatures (the main path; one per member where
  the group is over the payload caps, each then a group of one):
  kernel K3 (pileup/snp_pileup.py) selects each candidate's 41
  neighbour columns and builds its pileup, one launch a cohort
  (infer_snp_group);
- a chunk's SnpChunkFeatures (--no_snp_group_payload, snp_group_span
  <= -1, a chunk over the group payload caps on its own): K3 on the
  chunk's wire, its windows the whole neighbour array (infer_snp_chunk);
- a chunk's dense SnpBatch (--no_dedup_transfer, a chunk over
  _TABLE_CELL_CAP): kernel K5 (pileup/snp_dense.py) (infer_snp_batch).
The three build the same x, bit for bit, for the same candidates; the
SNP CNN (models/snp.py: on CUDA its convolutions as one launch of kernel
K6, models/snp_trunk.py, then fc1 and the heads in torch) runs on it in
cfg.batch_size rows (cnn_in_slices). On CUDA each full slice replays a
CUDA graph of the forward, captured once a replica, ploidy and batch
size (_CnnGraph): one runtime call in place of the forward's, the same
kernels, so the same probabilities bit for bit; the last, shorter slice
runs eagerly.
With several replicas (SnpCallerState.replicas, one a card) each route
splits its rows over them in cfg.batch_size slices (sharding.dp_rows):
the kernel and the CNN of a slice run on its replica, and the
probabilities are those of one device, bit for bit.
A route only describes its launches: the replica, the ploidy, the
kernel call that builds (x, ref) and the rows of the payload it fills.
One path (_infer_launches) queues each launch's kernel, CNN and copy
back, and its one finisher writes every part into its rows of one array
(a decode group's members are slices of it).

A decode group's host work is recorded in a running torch.profiler trace
as spans (runtime/metrics.span), each tagged with the group's number,
the `snp.groups` counter's value once the group is counted: `snp.cohorts`
(site depth, the depth check, the coverage scale and the cohorts'
packing), `snp.wire` and `snp.copy_in` (the wire's host layout and the
payload's copies, pileup/snp_pileup.py), `snp.launch` (queueing K3 and
the CNN's forwards: graph replays, each counted in
`snp.cnn_graph_replays`, and the eager tail) and `snp.copy_out` (the
finisher's wait for each part's probabilities on the host); the chunk
and dense routes record their launches and copies in the same spans,
untagged. With no profiler running a span costs a flag check.

Each part's probabilities come back through _CopyBack: on CUDA a copy
queued behind the part's CNN, whose own event the finisher waits on, so
it never waits for work queued later (the next group's).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .io.vcf import VcfWriter, standard_snp_header, view_filter
from .models import (HaploidSNPModel, SNPModel, load_model,
                     torch_state_dict_from_params)
from .models.registry import HAPLOID_TRAIN_COVERAGE
from .pileup.snp_dense import snp_dense_pileup
from .pileup.snp_features import (SnpChunkFeatures, SnpGroupFeatures,
                                  get_snp_candidates, get_snp_chunk_features)
from .pileup.snp_pileup import (chunk_wire, group_wire, site_depth,
                                snp_pileup, to_device)
from .runtime import sharding, watchdog
from .runtime.chunker import group_adjacent_chunks
from .runtime.device import resolve_device, to_host
from .runtime.metrics import count, span, total

NUM_TO_BASE = "AGTC"  # snpCaller.py:14


def _phred(p, cap=99, scale=10, eps=1e-10):
    """min(cap, -scale*log10(eps + 1 - p)) with the reference's effective
    NaN behavior: float32 softmax can give p marginally above 1, where
    numpy log10 yields NaN and Python's min(cap, nan) returns cap
    (snpCaller.py:135 et al.) — so out-of-domain clamps to cap."""
    x = eps + 1.0 - float(p)
    if x <= 0:
        return float(cap)
    return min(cap, -scale * math.log10(x))


@dataclass
class SnpCallerState:
    model: SNPModel
    train_coverage: float
    hap_model: HaploidSNPModel
    device: torch.device
    # in-process data parallelism: [(device, model, hap_model)] of every
    # replica, the first this state's own; one entry on a single device
    replicas: list
    hap_train_coverage: float = HAPLOID_TRAIN_COVERAGE

    def __post_init__(self):
        self.replicas = [SnpReplica(r) for r in self.replicas]

    @property
    def devices(self):
        return [dev for dev, _m, _h in self.replicas]

    @classmethod
    def create(cls, snp_model_name, device="cuda", devices="auto"):
        """The diploid pack plus `haploid`, with the pack's `.coverage`
        training depth; "cuda" without a GPU raises. `devices`: the
        replicas' devices ("auto": sharding.inference_devices, every
        card of a bare "cuda" when there are two or more; None: one
        device), each holding a copy of the weights."""
        dev = resolve_device(device)

        def _load(module, name):
            params, cov = load_model("snp", name)
            module.load_state_dict(torch_state_dict_from_params(params))
            return module.to(dev).eval(), cov

        model, cov = _load(SNPModel(), snp_model_name)
        hap_model, _ = _load(HaploidSNPModel(), "haploid")
        reps = sharding.replicas(dev, devices, model, hap_model)
        return cls(model=reps[0][1], train_coverage=cov,
                   hap_model=reps[0][2], device=reps[0][0], replicas=reps)


def _coverage_norm(state, feats, ploidy, cfg):
    """Coverage scale of a payload's rows (a group member, a chunk's
    features or a dense batch) in numpy float32, as the JAX package
    computes it (snp_caller.py:1081-1086, :1166-1172, :1442-1449)."""
    train_cov = state.hap_train_coverage if ploidy == "haploid" \
        else state.train_coverage
    if cfg.disable_coverage_normalization:
        return train_cov / np.maximum(feats.dp.astype(np.float32), 1e-6)
    cov = feats.coverage
    return np.full(len(feats), train_cov / cov if cov > 0 else 1.0,
                   np.float32)


def _check_depth(depth, rows, maxcov):
    """K3 counts every covering read of a normal row: refuse a normal row
    deeper than maxcov (the payload's deep rows carry sampled ids)."""
    if len(rows) and depth[rows].max() > maxcov:
        raise ValueError("a normal row is deeper than maxcov=%d" % maxcov)


class SnpReplica(tuple):
    """One replica of a SnpCallerState: the (device, model, hap_model)
    that sharding.replicas gives, and the CUDA graphs of its CNN's full
    slices (`graphs`, by (ploidy, rows)), captured on first use into one
    memory pool of its own. A replay's output is read before the next
    replay is queued (_CnnGraph), so the graphs may share the pool."""

    def __new__(cls, replica):
        rep = super().__new__(cls, replica)
        rep.graphs = {}
        rep.pool = None
        return rep

    def cnn_graph(self, ploidy, forward, xs, rs):
        """The graph of `forward` at (ploidy, len(xs)) on xs's device,
        captured now if this replica has none yet."""
        key = (ploidy, len(xs))
        if key not in self.graphs:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs[key] = _CnnGraph(forward, xs, rs, self.pool)
        return self.graphs[key]


class _CnnGraph:
    """A CNN forward over a fixed number of rows, captured as a CUDA graph
    over static input buffers. A call copies its slice into them, replays
    the graph and copies the static output into the caller's rows, each
    on the device's current stream, so that the next call's copies and
    replay, which rewrite the buffers, queue behind this one's. Capture
    synchronises the device; it happens at a replica's first full slice
    of each ploidy and batch size. Each replay adds to `k6.launches` the
    K6 launches its capture recorded (k6_launches)."""

    def __init__(self, forward, xs, rs, pool):
        dev = xs.device
        with torch.cuda.device(dev):
            self.x = torch.zeros_like(xs)
            self.ref = torch.zeros_like(rs)
            stream = torch.cuda.Stream(dev)
            # cuBLAS's lazy set-up, K6's weight packing and its shared
            # memory limit run before the capture
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                forward(self.x, self.ref)
            torch.cuda.current_stream(dev).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            # the capture runs no kernel: its K6 launches come off the
            # counter, and each replay counts them
            k6 = total("k6.launches")
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = forward(self.x, self.ref)
            self.k6_launches = total("k6.launches") - k6
            if self.k6_launches:
                count("k6.launches", -self.k6_launches)

    def __call__(self, xs, rs, dst):
        self.x.copy_(xs)
        self.ref.copy_(rs)
        self.graph.replay()
        dst.copy_(self.out)
        count("snp.cnn_graph_replays")
        if self.k6_launches:
            count("k6.launches", self.k6_launches)


def cnn_in_slices(x, ref, bs, forward, full=None):
    """The (B, 4) probabilities of x (B, 5, 41, 5) and ref (B, 4) in
    slices of bs rows, each written into its rows of one tensor on x's
    device: a full slice by full(xs, rs, dst) where `full` is given (a
    _CnnGraph), every other slice, and the last, shorter one, by
    forward(xs, rs)."""
    probs = torch.empty((x.shape[0], 4), device=x.device)
    for lo in range(0, x.shape[0], bs):
        xs, rs, dst = x[lo:lo + bs], ref[lo:lo + bs], probs[lo:lo + bs]
        if full is not None and len(xs) == bs:
            full(xs, rs, dst)
        else:
            dst.copy_(forward(xs, rs))
    return probs


def _snp_cnn(replica, ploidy, x, ref, bs):
    """A replica's SNP CNN over x (B, 5, 41, 5) in slices of bs rows →
    the (B, 4) probabilities on x's device (cnn_in_slices). On CUDA each
    full slice replays the replica's graph of the forward (SnpReplica);
    on the CPU every slice runs eagerly."""
    _dev, model, hap_model = replica
    if ploidy == "haploid":
        forward = hap_model
    else:
        def forward(xs, rs):
            return model(xs, rs)[0][:, :, 1]
    full = None
    if x.device.type == "cuda" and x.shape[0] >= bs:
        # a replay runs no Python: bring K6's packed weights up to date
        (hap_model if ploidy == "haploid" else model).trunk_weights()
        full = replica.cnn_graph(ploidy, forward, x[:bs], ref[:bs])
    return cnn_in_slices(x, ref, bs, forward, full)


class _CopyBack:
    """A part's (B, 4) probabilities on their way to the host. On CUDA
    the copy is queued at once, into pinned memory on the current stream
    of the part's device (runtime/device.to_host), with an event of its
    own after it, and counted in snp.async_copy_backs; the device tensor
    is kept until the copy has been read. On the CPU the tensor is the
    host's already."""

    def __init__(self, probs):
        self.probs = probs
        self.host, self.done = to_host(probs)
        if self.done is not None:
            count("snp.async_copy_backs")

    def numpy(self):
        """The probabilities as a numpy array: waits for the part's own
        copy (never for the stream, which may hold later work); on the
        CPU counts one snp.blocking_copies."""
        if self.done is None:
            count("snp.blocking_copies")
        else:
            self.done.synchronize()
        return self.host.numpy()


# K3's row arrays: each launch copies these of its rows to its device
_K3_ROWS = {"cand_site": np.int32, "cand_pos": np.int32, "lo": np.int32,
            "hi": np.int32, "norm": np.float32, "rids": np.int32}


def _cohorts(state, members, depth, maxcov, cfg):
    """A payload's rows packed into (ploidy, deep) cohorts. members:
    [(mi, sec, ploidy, lo, hi)], sec a group member or a chunk's features
    and [lo, hi) its window of the neighbour arrays. Returns [(ploidy,
    deep, c)] sorted by (deep, ploidy), c {name: array} with the rows'
    _K3_ROWS, their member `mi` and their row `j` in it. Normal rows
    count every covering read, which the payload keeps within maxcov
    (checked here against `depth`, for both devices); deep rows (depth >
    maxcov) count their host-sampled read ids."""
    cohorts = {}  # (ploidy, deep) -> dict of row lists
    for mi, sec, ploidy, lo, hi in members:
        norm = _coverage_norm(state, sec, ploidy, cfg)
        deep_mask = np.zeros(len(sec), bool)
        deep_mask[sec.deep_idx] = True
        for deep in (False, True):
            rows = sec.deep_idx if deep else np.flatnonzero(~deep_mask)
            if not len(rows):
                continue
            if not deep:
                _check_depth(depth, sec.cand_site[rows], maxcov)
            c = cohorts.setdefault((ploidy, deep),
                                   {k: [] for k in (*_K3_ROWS, "mi", "j")})
            nr = len(rows)
            c["cand_site"].append(sec.cand_site[rows])
            c["cand_pos"].append(sec.cand_pos32[rows])
            c["norm"].append(norm[rows])
            c["lo"].append(np.full(nr, lo, np.int32))
            c["hi"].append(np.full(nr, hi, np.int32))
            c["mi"].append(np.full(nr, mi, np.int32))
            c["j"].append(rows)
            if deep:
                c["rids"].append(sec.deep_rids)
    return [(ploidy, deep, {k: np.concatenate(v) for k, v in c.items() if v})
            for (ploidy, deep), c in sorted(cohorts.items(),
                                            key=lambda kv: (kv[0][1],
                                                            kv[0][0]))]


def _shares(state, n, cfg):
    """The state's replicas' shares of n rows (sharding.dp_rows at
    cfg.batch_size): [(r, rows)], the empty shares left out."""
    return [(r, rows) for r, rows in enumerate(sharding.dp_rows(
        n, cfg.batch_size, state.devices)) if len(rows)]


def _k3_launches(state, cohorts, cfg, wire, maxcov, arg=None):
    """K3's launches of cohorts (_cohorts): each cohort's rows split over
    the state's replicas (_shares), one launch a cohort and replica, on
    the replica's device, to which the payload goes once (wire(device))
    and then the launch's rows (span snp.copy_in, tagged with `arg`).
    Returns [(ploidy, deep, args, mi, j, r)] in launch order, where
    snp_pileup(*args) builds the pileups of replica r's rows, row k of
    them member mi[k]'s row j[k]."""
    wires = {}  # replica -> the payload on its device
    out = []
    for ploidy, deep, c in cohorts:
        for r, rows in _shares(state, len(c["j"]), cfg):
            dev = state.devices[r]
            if r not in wires:
                wires[r] = wire(dev)
            with span("snp.copy_in", arg):
                t = to_device({k: c[k][rows].astype(dtype, copy=False)
                               for k, dtype in _K3_ROWS.items() if k in c},
                              dev)
                n_valid = torch.full((len(rows),), maxcov, dtype=torch.int32,
                                     device=dev) if deep else None
            args = (wires[r], t["cand_site"], t["cand_pos"], t["lo"],
                    t["hi"], t["norm"], t.get("rids"), n_valid)
            out.append((ploidy, deep, args, c["mi"][rows], c["j"][rows], r))
    return out


def pileup_cohorts(state, gf, cfg, arg=None):
    """K3's launches for one decode group, as infer_snp_group makes them.

    The members' rows pack into (ploidy, deep) cohorts (_cohorts, each
    member's window its [nbr_lo, nbr_hi)), and each cohort's rows split
    over the state's replicas (_k3_launches): one launch a cohort and
    replica. Returns [(ploidy, deep, args, dst_mi, dst_j, r)] in launch
    order, where snp_pileup(*args) builds the pileups of replica r's rows
    and row k of it belongs to member dst_mi[k], row dst_j[k]. Spans,
    tagged with `arg`: snp.cohorts up to the first copy, then the wire's
    (group_wire) and snp.copy_in for each launch's rows."""
    with span("snp.cohorts", arg):
        cohorts = _cohorts(state, [
            (mi, sec, sec.ploidy, sec.nbr_lo, sec.nbr_hi)
            for mi, (_oi, sec) in enumerate(gf.members)
            if sec is not None and len(sec)], site_depth(gf), gf.maxcov, cfg)
    return _k3_launches(state, cohorts, cfg,
                        lambda dev: group_wire(gf, dev, arg), gf.maxcov, arg)


def chunk_cohorts(state, feats, cfg, ploidy):
    """K3's launches for one chunk's payload (SnpChunkFeatures) called at
    `ploidy`, as infer_snp_chunk makes them: the chunk as one member whose
    window is the whole neighbour array [0, M), its normal rows, then its
    deep rows, split over the state's replicas (_k3_launches), the
    payload going to each replica's device once as a chunk wire. Returns
    [(deep, args, rows, r)] where snp_pileup(*args) builds the pileups of
    the candidates `rows` on replica r."""
    cohorts = _cohorts(state, [(0, feats, ploidy, 0, len(feats.nbr_pos))],
                       site_depth(feats), feats.maxcov, cfg)
    return [(deep, args, rows, r) for _p, deep, args, _mi, rows, r in
            _k3_launches(state, cohorts, cfg,
                         lambda dev: chunk_wire(feats, dev), feats.maxcov)]


def _k3(*args):
    """K3's (x, ref) of a launch's rows: snp_pileup, looked up at the call;
    ref is the centre-ref one-hot, all zero for N as jax.nn.one_hot's."""
    x, _soc, ref = snp_pileup(*args)
    return x, ref


def _infer_launches(state, launches, n, cfg, async_mode, arg=None,
                    sections=None):
    """The three routes' one launch-and-finish path. launches: [(r,
    ploidy, pileup, args, dst)], pileup(*args) giving (x, ref) on replica
    r's device for rows dst of the payload's n rows.

    Each launch, in a snp.launch span: its pileup, the replica's CNN in
    cfg.batch_size rows (_snp_cnn) and the probabilities' copy back
    (_CopyBack), queued on the current stream. The finisher waits for
    each part's copy (span snp.copy_out), beats a supervising --watchdog
    and writes the part into its rows of one (n, 4) float32 array, which
    it returns, or np.split's views of it at the row offsets `sections`.
    Spans are tagged with `arg`. Returns the finisher (async_mode=True)
    or its result."""
    parts = []  # (dst, _CopyBack)
    with torch.inference_mode():
        for r, ploidy, pileup, args, dst in launches:
            with span("snp.launch", arg):
                x, ref = pileup(*args)
                parts.append((dst, _CopyBack(_snp_cnn(
                    state.replicas[r], ploidy, x, ref, cfg.batch_size))))

    def finish():
        out = np.zeros((n, 4), np.float32)
        for dst, back in parts:
            with span("snp.copy_out", arg):
                probs = back.numpy()
            # after the copy-back, not at the launch: a hung kernel stops
            # the beats (launches are asynchronous)
            watchdog.beat()
            out[dst] = probs
        return out if sections is None else np.split(out, sections)

    return finish if async_mode else finish()


def infer_snp_group(state, gf, cfg, async_mode=False):
    """Run the model over a whole decode group from ONE device payload.

    gf: pileup.snp_features.SnpGroupFeatures. Each (ploidy, deep) cohort
    of the members' rows takes one K3 launch (pileup_cohorts) and the CNN
    in chunks of cfg.batch_size rows; member mi's row j is row
    offsets[mi] + j of the group's probabilities.

    Returns a list of per-member (B, 4) probability arrays aligned with
    gf.members, views of that one array ((0, 4) for an empty or None
    member) (async_mode=True: a zero-arg finisher returning it; the
    launches and each part's copy back are queued on the current stream,
    and the finisher waits for the copies: _infer_launches). Counts the
    group in `snp.groups`, whose value tags its spans."""
    g = count("snp.groups")
    offsets = np.cumsum([0] + [len(sec) if sec is not None else 0
                               for _oi, sec in gf.members])
    launches = [(r, ploidy, _k3, args, offsets[mi] + j) for
                ploidy, _deep, args, mi, j, r in pileup_cohorts(state, gf,
                                                                cfg, g)]
    return _infer_launches(state, launches, offsets[-1], cfg, async_mode,
                           g, offsets[1:-1])


def infer_snp_chunk(state, feats, cfg, ploidy, async_mode=False):
    """Run the model over one chunk's SnpChunkFeatures: K3 on the chunk's
    wire (chunk_cohorts), the CNN in cfg.batch_size rows.

    Returns the (B, 4) probabilities in candidate order (async_mode=True:
    a zero-arg finisher returning them; the launches and the copies back
    are queued on the current stream, and the finisher waits for the
    copies: _infer_launches)."""
    return _infer_launches(state, [
        (r, ploidy, _k3, args, rows)
        for _deep, args, rows, r in chunk_cohorts(state, feats, cfg, ploidy)
    ], len(feats), cfg, async_mode)


def infer_snp_batch(state, batch, cfg, ploidy, async_mode=False):
    """Run the model over one chunk's dense SnpBatch: its rows split over
    the state's replicas (_shares), one K5 launch a replica on its device
    (codes cut to the batch's deepest row's sampled reads, which lie
    first in every row), the CNN in cfg.batch_size rows. Returns as
    infer_snp_chunk does."""
    B = len(batch)
    launches = []
    if B:
        norm = _coverage_norm(state, batch, ploidy, cfg)
        R_b = max(1, int(batch.sampled_depth.max()))
        for r, rows in _shares(state, B, cfg):
            with span("snp.copy_in"):
                t = to_device({
                    "codes": batch.codes[rows, :R_b],
                    "read_mask": batch.read_mask[rows, :R_b],
                    "col_ref": batch.col_ref[rows],
                    "col_valid": batch.col_valid[rows],
                    "center_ref": batch.center_ref[rows],
                    "norm": norm[rows]}, state.devices[r])
            launches.append((r, ploidy, snp_dense_pileup,
                             tuple(t.values()), rows))
    return _infer_launches(state, launches, B, cfg, async_mode)


def infer_snp_any(state, feats, cfg, ploidy, async_mode=False):
    """A chunk's payload by its type: SnpChunkFeatures on K3
    (infer_snp_chunk), a dense SnpBatch on K5 (infer_snp_batch)."""
    infer = infer_snp_chunk if isinstance(feats, SnpChunkFeatures) \
        else infer_snp_batch
    return infer(state, feats, cfg, ploidy, async_mode=async_mode)


def decode_diploid(batch, probs):
    """Genotype decision tree → VCF body lines (snpCaller.py:113-163)."""
    lines = []
    pred_sort = np.argsort(probs, axis=1)
    n_ge = (probs >= 0.5).sum(axis=1)
    for j in range(len(batch)):
        pos1 = int(batch.pos[j]) + 1
        ref = int(batch.center_ref[j])
        pj = probs[j]
        dp = int(batch.dp[j])
        info = "PR=" + ",".join("%.4f" % x for x in pj[[0, 3, 1, 2]]) + \
               ";FQ=%.4f" % batch.freq[j]
        fwd, rev = batch.fwd_dp[j], batch.rev_dp[j]
        ref_dp = (int(fwd[ref]), int(rev[ref]))
        pred1, pred2 = int(pred_sort[j, -1]), int(pred_sort[j, -2])

        def line(alt, qual, filt, gt, sample_tail):
            return "%s\t%d\t.\t%s\t%s\t%.3f\t%s\t%s\tGT:DP:VF:AD:ADF:ADR\t%s:%s\n" % (
                batch.contig, pos1, NUM_TO_BASE[ref], alt, qual, filt, info,
                gt, sample_tail)

        if n_ge[j] >= 2:  # het-like
            if pred1 == ref:
                alt = pred2
                alt_dp = (int(fwd[alt]), int(rev[alt]))
                qual = _phred(pj[alt])
                lines.append(line(
                    NUM_TO_BASE[alt], qual, "PASS", "0/1",
                    "%d:%.4f:%d,%d:%d,%d:%d,%d" % (
                        dp, sum(alt_dp) / dp, sum(ref_dp), sum(alt_dp),
                        ref_dp[0], alt_dp[0], ref_dp[1], alt_dp[1])))
            elif pred2 == ref and pj[pred2] >= 0.5:
                alt = pred1
                alt_dp = (int(fwd[alt]), int(rev[alt]))
                qual = _phred(pj[pred2])
                lines.append(line(
                    NUM_TO_BASE[alt], qual, "PASS", "0/1",
                    "%d:%.4f:%d,%d:%d,%d:%d,%d" % (
                        dp, sum(alt_dp) / dp, sum(ref_dp), sum(alt_dp),
                        ref_dp[0], alt_dp[0], ref_dp[1], alt_dp[1])))
            elif pred2 != ref and pred1 != ref and pj[pred2] >= 0.5:
                alt1_dp = (int(fwd[pred1]), int(rev[pred1]))
                alt2_dp = (int(fwd[pred2]), int(rev[pred2]))
                qual = _phred(pj[pred2])
                lines.append(line(
                    "%s,%s" % (NUM_TO_BASE[pred1], NUM_TO_BASE[pred2]),
                    qual, "PASS", "1/2",
                    "%d:%.4f,%.4f:%d,%d,%d:%d,%d,%d:%d,%d,%d" % (
                        dp, sum(alt1_dp) / dp, sum(alt2_dp) / dp,
                        sum(ref_dp), sum(alt1_dp), sum(alt2_dp),
                        ref_dp[0], alt1_dp[0], alt2_dp[0],
                        ref_dp[1], alt1_dp[1], alt2_dp[1])))
        elif n_ge[j] == 1 and ref != pred1 and pj[pred1] >= 0.5:  # hom-alt
            alt_dp = (int(fwd[pred1]), int(rev[pred1]))
            qual = _phred(pj[pred1])
            lines.append(line(
                NUM_TO_BASE[pred1], qual, "PASS", "1/1",
                "%d:%.4f:%d,%d:%d,%d:%d,%d" % (
                    dp, sum(alt_dp) / dp, sum(ref_dp), sum(alt_dp),
                    ref_dp[0], alt_dp[0], ref_dp[1], alt_dp[1])))
        else:
            if n_ge[j] == 1 and ref == pred1:
                qual = _phred(pj[pred1])
                lines.append(line(".", qual, "REF", "./.", "%d:.:.:.:." % dp))
            else:
                lines.append(line(".", 0.0, "LOW", "./.", "%d:.:.:.:." % dp))
    return lines


def decode_haploid(batch, probs):
    """Haploid decode (snpCaller.py:187-198)."""
    lines = []
    preds = np.argmax(probs, axis=1)
    for j in range(len(batch)):
        pos1 = int(batch.pos[j]) + 1
        ref = int(batch.center_ref[j])
        pred = int(preds[j])
        pj = probs[j]
        info = "PR=" + ",".join("%.4f" % x for x in pj[[0, 3, 1, 2]]) + \
               ";FQ=%.4f" % batch.freq[j]
        qual = _phred(pj[pred], cap=999, scale=100)
        filt = "PASS" if pred != ref else "REF"
        lines.append(
            "%s\t%d\t.\t%s\t%s\t%.3f\t%s\t%s\tGT:DP:VF:AD:ADF:ADR\t%s:%d:%.4f:.:.:.\n"
            % (batch.contig, pos1, NUM_TO_BASE[ref], NUM_TO_BASE[pred], qual,
               filt, info, "1/1", int(batch.dp[j]), batch.freq[j]))
    return lines


def call_chunk(state, bam, fasta, chunk, cfg, exclude=None):
    """Feature-gen + inference + decode for one chunk → VCF body lines,
    on the state's device: the chunk's SnpChunkFeatures (K3 on its
    chunk wire), or with cfg.dedup_transfer off its dense SnpBatch
    (K5)."""
    builder = get_snp_chunk_features \
        if getattr(cfg, "dedup_transfer", True) else get_snp_candidates
    ploidy = chunk.get("ploidy", "diploid")
    batch = builder(
        bam, fasta, chunk,
        seq_type=cfg.sequencing, mincov=cfg.mincov, maxcov=cfg.maxcov,
        min_allele_freq=cfg.min_allele_freq, min_nbr_sites=cfg.min_nbr_sites,
        threshold=cfg.threshold, ploidy=ploidy, exclude=exclude)
    if len(batch) == 0:
        return []
    probs = infer_snp_any(state, batch, cfg, ploidy)
    if ploidy == "haploid":
        return decode_haploid(batch, probs)
    return decode_diploid(batch, probs)


def _group_adjacent(ordered_chunks, todo, cfg):
    """Pack coordinate-adjacent pending chunks into shared-decode groups;
    None for snp_group_span <= -1 (one decode a chunk:
    runtime/workers.snp_features_worker).

    The group span adapts to keep ≥ ~4 tasks per feature worker while
    amortizing the ±50 kb halo re-decode and per-window decode setup.
    Groups never span contigs, gaps (e.g. chunks completed by --resume),
    or ploidy changes."""
    span_cap = int(getattr(cfg, "snp_group_span", 0) or 0)
    if span_cap <= -1:
        return None
    if span_cap == 0:
        total = sum(c["end"] - c["start"] + 1 for c in ordered_chunks)
        span_cap = max(500_000,
                       min(8_000_000, total // max(1, 4 * cfg.cpu)))
    return group_adjacent_chunks(ordered_chunks, todo, span_cap)


def call_snps(cfg, bam, regions_list, chunks, out_dir, progress=None,
              manifest=None, metrics=None, exclude_path=None):
    """Run SNP calling over all chunks; write unfiltered + PASS VCFs.

    The payloads are built on the host from cfg.bam, cfg.ref and
    exclude_path, inline at --cpu 1 and by cfg.cpu feature workers
    otherwise, in completion order (runtime/scheduler.feature_stream):
    one task a decode group (runtime/workers.snp_features_group_worker),
    or one a chunk where cfg.snp_group_span <= -1
    (snp_features_worker). The CRAM windows those decodes gave the
    Python decoder are added to `bam`'s count (the main process's
    reader). This process infers each payload on the device by its type
    (SnpGroupFeatures: infer_snp_group; a chunk's SnpChunkFeatures or
    SnpBatch: infer_snp_any) with up to cfg.snp_pipeline_depth payloads
    in flight (a payload's wait for its copies back and its decode come
    after the next one's launches are queued); lines are stored by chunk
    index, so the order of arrival changes nothing. With a RunManifest,
    completed chunks are reloaded from their shard files. The
    `snp.features` timer is this process's wait for the next task's
    payloads. Returns the PASS VCF path (snpCaller.py:287)."""
    from contextlib import nullcontext

    from .runtime.scheduler import feature_stream
    from .runtime.workers import (cfg_kwargs_for_workers,
                                  snp_features_group_worker,
                                  snp_features_worker)

    state = SnpCallerState.create(cfg.snp_model, device=cfg.device)
    timer = metrics.timer if metrics is not None else (lambda _: nullcontext())
    contigs = list(dict.fromkeys(x[0] for x in regions_list))
    order = sorted(range(len(chunks)),
                   key=lambda i: (contigs.index(chunks[i]["chrom"]),
                                  chunks[i]["start"]))
    ordered_chunks = [chunks[i] for i in order]

    results = {}
    todo = []
    for idx, chunk in enumerate(ordered_chunks):
        if manifest is not None and manifest.is_done("snp", chunk):
            with open(manifest.shard_path("snp", chunk)) as fh:
                results[idx] = fh.readlines()
            if progress:
                progress(1)
        else:
            todo.append(idx)

    def _store(idx, lines):
        results[idx] = lines
        if manifest is not None:
            chunk = ordered_chunks[idx]
            shard = os.path.join(
                manifest.shard_dir, "snp_%s_%d.body" % (chunk["chrom"],
                                                        chunk["start"]))
            with open(shard, "w") as fh:
                fh.writelines(lines)
            manifest.mark_done("snp", chunk, shard)
        if progress:
            progress(1)

    # [(members, finisher)]: members [(chunk index, payload section)] and
    # finisher() their probabilities, one array a member
    in_flight = []
    depth = max(1, int(cfg.snp_pipeline_depth))

    def _finalize_one():
        members, finish = in_flight.pop(0)
        for (oi, sec), probs in zip(members, finish()):
            if sec is None or len(sec) == 0:
                _store(oi, [])
            elif ordered_chunks[oi].get("ploidy") == "haploid":
                _store(oi, decode_haploid(sec, probs))
            else:
                _store(oi, decode_diploid(sec, probs))

    def _infer(p):
        if isinstance(p, SnpGroupFeatures):
            return p.members, infer_snp_group(state, p, cfg, async_mode=True)
        idx, feats = p
        ploidy = ordered_chunks[idx].get("ploidy", "diploid")
        finish = infer_snp_any(state, feats, cfg, ploidy, async_mode=True)
        return [p], lambda: [finish()]

    init_args = (cfg.bam, cfg.ref, cfg_kwargs_for_workers(cfg), exclude_path)
    groups = _group_adjacent(ordered_chunks, todo, cfg)
    if groups is None:
        stream = ((i, [(todo[i], feats)], pyw) for i, feats, pyw in
                  feature_stream([ordered_chunks[i] for i in todo],
                                 snp_features_worker, init_args, cfg.cpu))
    else:
        stream = feature_stream(groups, snp_features_group_worker,
                                init_args, cfg.cpu)
    while True:
        with timer("snp.features"):
            item = next(stream, None)
        if item is None:
            break
        _i, payloads, py_windows = item
        if py_windows:
            bam.note_python_windows(py_windows)
        # a decode group's payload, one a member where the group is over
        # the payload caps, or (chunk index, its own payload)
        for p in payloads:
            with timer("snp.infer_decode"):
                members, finish = _infer(p)
                while len(in_flight) >= depth:
                    _finalize_one()
                in_flight.append((members, finish))
            if metrics is not None:
                metrics.count("snp_candidates", sum(
                    len(sec) for _oi, sec in members if sec is not None))
    with timer("snp.infer_decode"):
        while in_flight:  # drain the inference pipeline
            _finalize_one()

    header = standard_snp_header(contigs, cfg.sample)
    all_path = os.path.join(out_dir, "%s.unfiltered.snps.vcf.gz" % cfg.prefix)
    pass_path = os.path.join(out_dir, "%s.snps.vcf.gz" % cfg.prefix)
    with VcfWriter(all_path, header) as w:
        for idx in range(len(ordered_chunks)):
            for ln in results.get(idx, []):
                w.write(ln)
    view_filter(all_path, pass_path, lambda r: r.filter == "PASS")
    return pass_path
