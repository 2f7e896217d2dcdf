"""The port's NW kernels' plain twins and BatchAligner against the JAX
package: K1's twin against _batch_nw and the interpret-mode Pallas
kernel, K2's twin against _walk_device (exact), cigars against nw_align.
The CUDA kernels against their twins: tests/test_torch_gpu.py."""

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
                                                 encode_pairs)
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

