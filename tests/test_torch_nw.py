"""The port's NW kernels' plain twins and BatchAligner against the JAX
package: K1's twin against _batch_nw and the interpret-mode Pallas
kernel, K2's twin against _walk_device (exact), K4's twin against the
host walk refine_diag_ops(_walk_to_cigar(...)) and nw_align, cigars
against nw_align, packed and not. The CUDA kernels against their twins:
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanocaller_tpu.align.batch_nw import _batch_nw, _walk_device
from nanocaller_tpu.align.nw import nw_align
from nanocaller_tpu.align.pallas_nw import batch_nw_tb_pallas
from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.align.batch_nw import (BatchAligner,
                                                 _traceback_matrix,
                                                 _walk_to_cigar,
                                                 encode_pairs, pad_bytes,
                                                 refine_diag_ops)
from nanocaller_tpu_torch.align.nw import pack_cigar, unpack_cigar
from nanocaller_tpu_torch.sim import TIE_KINDS, tie_heavy_pairs

from torch_threads import _torch_threads  # noqa: F401 (autouse)

SCORINGS = [(20, -10, 9, 1), (5, -4, 8, 1)]


def _codes(rng, B, n, pad_tail=0):
    c = rng.integers(0, 5, (B, n)).astype(np.int8)
    if pad_tail:
        c[:, n - pad_tail:] = 4
    return c


def _seq(rng, n):
    return "".join("ACGT"[int(b)] for b in rng.integers(0, 4, n))


def _mutate(rng, s, rate=0.1):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append("ACGT"[int(rng.integers(4))])
        elif r < rate:
            out.append(ch + "ACGT"[int(rng.integers(4))])
        else:
            out.append(ch)
    return "".join(out)


class TestTbTwin:
    @pytest.mark.parametrize("params", SCORINGS)
    @pytest.mark.parametrize(
        "Q,R,kind", [(48, 40, "random"), (31, 57, "random"),
                     (40, 41, "random")] + [(48, 40, k) for k in TIE_KINDS],
        ids=["48-40", "31-57", "40-41"] + ["48-40-" + k for k in TIE_KINDS])
    def test_vs_batch_nw(self, params, Q, R, kind):
        rng = np.random.default_rng(Q * 100 + R)
        if kind == "random":
            qc = _codes(rng, 8, Q, pad_tail=5)
            rc = _codes(rng, 8, R, pad_tail=3)
        else:  # the traceback is decided by ties
            qc, rc, _, _ = encode_pairs(tie_heavy_pairs(rng, 8, Q, R, kind),
                                        Q, R)
        _, want = _batch_nw(qc, rc, *params, Q, R)
        got = K.nw_tb(torch.from_numpy(qc), torch.from_numpy(rc), *params)
        assert got.dtype == torch.uint8 and got.shape == (8, Q + 1, R + 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("params", SCORINGS)
    def test_vs_pallas_interpret(self, params):
        rng = np.random.default_rng(1)
        B, Q, R, W = 8, 48, 40, 64
        qc = rng.integers(0, 5, (B, Q)).astype(np.int8)
        rc = rng.integers(0, 5, (B, R)).astype(np.int8)
        want = batch_nw_tb_pallas(qc, rc, *params, Q, W, interpret=True)
        got = K.nw_tb_reference(torch.from_numpy(qc), torch.from_numpy(rc),
                                *params)
        np.testing.assert_array_equal(
            got.numpy().view(np.int8), np.asarray(want)[:, :, : R + 1])


class TestWalkTwin:
    @pytest.mark.parametrize(
        "params,kind", [(p, "random") for p in SCORINGS]
        + [(p, k) for k in TIE_KINDS for p in SCORINGS],
        ids=["params0", "params1"] + ["params%d-%s" % (n, k)
                                      for k in TIE_KINDS for n in (0, 1)])
    def test_vs_walk_device(self, params, kind):
        rng = np.random.default_rng(5)
        B, Q, R = 8, 40, 36
        if kind == "random":
            qc = _codes(rng, B, Q)
            rc = _codes(rng, B, R)
            qlens = rng.integers(0, Q + 1, B).astype(np.int32)
            rlens = rng.integers(0, R + 1, B).astype(np.int32)
            qlens[0] = rlens[1] = 0  # edge walks along one border
        else:  # the walk follows tracebacks decided by ties
            qc, rc, qlens, rlens = encode_pairs(
                tie_heavy_pairs(rng, B, Q, R, kind), Q, R)
        _, tb = _batch_nw(qc, rc, *params, Q, R)
        T = 2 * (Q + R) + 2
        want = np.asarray(_walk_device(tb, jnp.asarray(qlens),
                                       jnp.asarray(rlens), T))
        got = K.nw_walk(torch.from_numpy(np.array(tb)),
                        torch.from_numpy(qlens), torch.from_numpy(rlens), T)
        np.testing.assert_array_equal(got.numpy(), want)
        # the host oracle walks the same path
        for b in range(B):
            ops = [o for o in got.numpy()[b] if o][::-1]
            host = [k for k, _, _ in
                    _traceback_matrix(np.asarray(tb)[b], qlens[b], rlens[b])]
            assert ["diz"[o - 1] for o in ops] == host

    def test_short_T_rejected(self):
        tb = torch.zeros((1, 5, 5), dtype=torch.uint8)
        one = torch.ones(1, dtype=torch.int32)
        with pytest.raises(ValueError):
            K.nw_walk(tb, one, one, 10)

    @pytest.mark.parametrize("qlen,rlen", [(5, 4), (4, 5), (-1, 2), (2, -1)])
    def test_lengths_out_of_range_rejected(self, qlen, rlen):
        tb = torch.zeros((1, 5, 5), dtype=torch.uint8)
        ql = torch.tensor([qlen], dtype=torch.int32)
        rl = torch.tensor([rlen], dtype=torch.int32)
        with pytest.raises(ValueError, match="qlens"):
            K.nw_walk(tb, ql, rl, 18)

    def test_range_check_stays_on_the_host(self, monkeypatch):
        """The lengths are CPU tensors, checked where they are: a good
        pair walks, a bad one raises, and neither moves a tensor to
        another device or reads one back."""
        def no_move(self, *a, **kw):
            raise AssertionError("nw_walk moved a tensor")

        tb = torch.zeros((2, 5, 5), dtype=torch.uint8)
        good = torch.tensor([4, 0], dtype=torch.int32)
        monkeypatch.setattr(torch.Tensor, "to", no_move)
        monkeypatch.setattr(torch.Tensor, "cuda", no_move)
        monkeypatch.setattr(torch.Tensor, "item", no_move)
        monkeypatch.setattr(K, "nw_walk_reference",
                            lambda tb, ql, rl, T: torch.zeros((2, T)))
        assert K.nw_walk(tb, good, good, 18).shape == (2, 18)
        with pytest.raises(ValueError, match="qlens"):
            K.nw_walk(tb, torch.tensor([5, 0], dtype=torch.int32), good, 18)
        # lengths on another device are refused before any check
        meta = torch.empty(2, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            K.nw_walk(tb, meta, good, 18)


class TestBatchAligner:
    def _pairs(self, rng, lens):
        pairs = []
        for n in lens:
            r = _seq(rng, n)
            pairs.append((_mutate(rng, r), r))
        return pairs

    @pytest.mark.parametrize("params", SCORINGS)
    def test_cigars_identical_to_nw_align(self, params):
        rng = np.random.default_rng(11)
        # every bucket, an odd length, out-of-bucket and empty strings
        lens = [5, 63, 64, 100, 130, 191, 200, 300, 400, 511]
        pairs = self._pairs(rng, lens)
        pairs += [("ACGT" * 140, "ACGTT" * 110), ("", "ACGT"), ("ACG", ""),
                  ("", ""), ("NNACGTN", "ACGTACGN")]
        al = BatchAligner(*params, device="cpu")
        got = al.align_many(pairs)
        m, x, go, ge = params
        want = [nw_align(q, r, match=m, mismatch=x, gap_open=go,
                         gap_extend=ge)[1] for q, r in pairs]
        assert got == want

    def test_launch_split_by_cap(self, monkeypatch):
        rng = np.random.default_rng(12)
        pairs = self._pairs(rng, [50] * 7)
        al = BatchAligner(device="cpu")
        monkeypatch.setattr(BatchAligner, "TB_CAP_BYTES", 3 * 65 * 65)
        calls = []
        orig = K.nw_tb_reference

        def spy(q, *a):
            calls.append(q.shape[0])
            return orig(q, *a)

        monkeypatch.setattr(K, "nw_tb_reference", spy)
        got = al.align_many(pairs)
        assert calls == [3, 3, 1]
        assert got == [nw_align(q, r)[1] for q, r in pairs]


    @pytest.mark.parametrize("params", SCORINGS)
    def test_packed_equals_unpacked(self, params):
        """packed=True gives read-only uint32 runs that unpack to the
        packed=False cigars, out-of-bucket and empty pairs included."""
        rng = np.random.default_rng(13)
        pairs = self._pairs(rng, [5, 64, 150, 300, 511])
        pairs += [("ACGT" * 140, "ACGTT" * 110), ("", "ACGT"), ("ACG", ""),
                  ("", ""), ("NNacgTN", "ACGTacgN")]
        al = BatchAligner(*params, device="cpu")
        plain = al.align_many(pairs)
        packed = al.align_many(pairs, packed=True)
        assert all(isinstance(c, np.ndarray) and c.dtype == np.uint32
                   and not c.flags.writeable for c in packed)
        assert [unpack_cigar(c) for c in packed] == plain
        assert all(np.array_equal(c, pack_cigar(p))
                   for c, p in zip(packed, plain))
        assert al.timers["encode"] > 0 and al.timers["device"] > 0


def _host_walk(ops_row, q, r):
    """The host walk K4 replaces, from one row of K2's op stream."""
    codes = [int(c) for c in ops_row if c][::-1]
    return refine_diag_ops(
        _walk_to_cigar([("diz"[c - 1], 0, 0) for c in codes]), q, r)


def _refined(cigar, q, r):
    """nw_align's cigar with its diagonal steps called by bytes ('=' only
    for equal bytes in "ACGT"), as the host walk and K4 call them."""
    walk = [("d" if op in (7, 8) else "i" if op == 1 else "z", 0, 0)
            for op, n in cigar for _ in range(n)]
    return refine_diag_ops(_walk_to_cigar(walk), q, r)


def _soft(rng, s, lo, hi):
    """s with [lo, hi) lowercased (a soft-masked stretch)."""
    return s[:lo] + s[lo:hi].lower() + s[hi:]


def _cigar_pairs(rng, Q, R):
    """Pairs for one bucket: mutated windows; soft-masked stretches in the
    reference, the query or both; N bytes on either side; a long match
    (a run over 15) and a long deletion and insertion; one empty side
    each (an all-gap walk) and both empty."""
    n = min(Q, R)
    base = _seq(rng, n)
    pairs = [(_mutate(rng, base)[:Q], base)]
    pairs.append((_mutate(rng, base, 0.03)[:Q], _soft(rng, base, 5, 60)))
    low = _soft(rng, base, 10, n - 10)
    pairs.append((low, low))
    pairs.append((_soft(rng, _mutate(rng, base, 0.05)[:Q], 0, 30), base))
    nb = list(base)
    for k in rng.integers(0, n, 6):
        nb[k] = "N"
    nq = list(_mutate(rng, base, 0.05)[:Q])
    for k in rng.integers(0, len(nq), 4):
        nq[k] = rng.choice(["N", "n"])
    pairs.append(("".join(nq), "".join(nb)))
    pairs.append((base[: n // 3] + base[n // 3 + 25 :], base))  # D run 25
    ins = _seq(rng, 20)
    pairs.append(((base[: n // 2] + ins + base[n // 2 :])[:Q], base))
    pairs += [("", base), (base[:Q], ""), ("", "")]
    return pairs


class TestCigarTwin:
    @pytest.mark.parametrize(
        "Q,R", [(64, 64), (128, 192), (192, 192), (256, 320), (320, 256),
                (512, 512)])
    @pytest.mark.parametrize("params", SCORINGS, ids=["allele", "msa"])
    def test_vs_host_walk_and_nw_align(self, Q, R, params):
        rng = np.random.default_rng(Q * 7 + R)
        pairs = _cigar_pairs(rng, Q, R)
        qraw, qlens = pad_bytes([q for q, _ in pairs], Q)
        rraw, rlens = pad_bytes([r for _, r in pairs], R)
        qc, rc, _, _ = encode_pairs(pairs, Q, R)
        tb = K.nw_tb(torch.from_numpy(qc), torch.from_numpy(rc), *params)
        ops = K.nw_walk(tb, torch.from_numpy(qlens), torch.from_numpy(rlens),
                        2 * (Q + R) + 2)
        runs, counts = K.nw_cigar(ops, torch.from_numpy(qraw),
                                  torch.from_numpy(rraw))
        assert runs.dtype == torch.int32 and runs.shape == (len(pairs),
                                                            Q + R)
        m, x, go, ge = params
        long_runs = 0
        for b, (q, r) in enumerate(pairs):
            got = runs[b, : counts[b]].numpy().view(np.uint32)
            want = _host_walk(ops[b].numpy(), q, r)
            assert unpack_cigar(got) == want, (b, q, r)
            ref = nw_align(q, r, match=m, mismatch=x, gap_open=go,
                           gap_extend=ge)[1]
            if q.upper() == q and r.upper() == r:
                assert want == ref  # no soft-masked byte: nw_align's own
            else:  # nw_align calls a/a '=' (K1's codes fold the case)
                assert want == _refined(ref, q, r)
            long_runs += sum(1 for _, n in want if n > 15)
        assert long_runs >= 3
        # the soft-masked identical pair: its lowercase stretch is 'X'
        n = min(Q, R)
        row = lambda b: unpack_cigar(runs[b, : counts[b]].numpy().view(
            np.uint32))
        assert row(2) == [(7, 10), (8, n - 20), (7, 10)]
        # one empty side walks all gaps; both empty, no op
        assert row(-3) == [(2, n)] and row(-2) == [(1, n)]
        assert counts[-1] == 0

    def test_bad_streams_give_minus_one(self):
        """A stream that reads past Q or R, or holds a code outside 0-3,
        counts -1 (BatchAligner raises on it)."""
        ops = torch.zeros((4, 10), dtype=torch.int8)
        ops[0, :4] = 1  # four diagonal steps for Q = 3
        ops[1, :3] = 3  # three deletions for R = 2
        ops[2, 0] = 5
        ops[3, 2:4] = torch.tensor([2, 1], dtype=torch.int8)
        q = torch.full((4, 3), ord("A"), dtype=torch.uint8)
        r = torch.full((4, 2), ord("A"), dtype=torch.uint8)
        runs, counts = K.nw_cigar(ops, q, r)
        assert counts.tolist() == [-1, -1, -1, 2]
        assert runs[3, :2].tolist() == [(1 << 4) | 7, (1 << 4) | 1]

    def test_align_many_raises_on_a_bad_count(self, monkeypatch):
        def bad(ops, q, r):
            return (torch.zeros((ops.shape[0], 4), dtype=torch.int32),
                    torch.full((ops.shape[0],), -1, dtype=torch.int32))

        monkeypatch.setattr("nanocaller_tpu_torch.align.batch_nw.nw_cigar",
                            bad)
        with pytest.raises(RuntimeError, match="nw_cigar"):
            BatchAligner(device="cpu").align_many([("ACGT", "ACGT")])

    def test_pad_bytes_scatters_by_offsets(self):
        raw, lens = pad_bytes(["AC", "", "GTa", "N"], 4)
        assert lens.tolist() == [2, 0, 3, 1]
        assert raw.tolist() == [[65, 67, 0, 0], [0] * 4, [71, 84, 97, 0],
                                [78, 0, 0, 0]]
        with pytest.raises(ValueError):
            pad_bytes(["ACGTA"], 4)
