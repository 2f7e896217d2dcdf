"""`snp_stream`: SNP decode-group payloads (nbench/gen_snp.py) through
snp_caller.infer_snp_group(state, payload, cfg, async_mode=True) with one
group in flight: the next group's launches are queued before the
previous group's finisher copies its probabilities back, as call_snps
runs at snp_pipeline_depth 1. Each group is one K3 launch a cohort and
the SNP CNN in cfg.batch_size rows. Units: candidate sites whose
probabilities reached the host.
"""

from types import SimpleNamespace

import numpy as np
import torch

from nbench import gen_snp, reference, work
from nbench.stream import CONTIG, Stream, load_pack


class Kind(Stream):
    enqueue_span = "snp.enqueue"
    finish_span = "snp.finish"

    def __init__(self, cfg, traffic, seed, device, root):
        from nanocaller_tpu_torch.snp_caller import SnpCallerState

        self.groups = gen_snp.make_pool(traffic, seed, cfg["maxcov"],
                                        cfg["sequencing"])
        self.inputs = [self._payload(g) for g in self.groups]
        super().__init__(cfg, traffic, seed, device, root)
        self.pcfg = SimpleNamespace(batch_size=cfg["batch_size"],
                                    maxcov=cfg["maxcov"],
                                    disable_coverage_normalization=False)
        self.state = SnpCallerState.create(cfg["snp_model"], device=device,
                                           devices=None)

    @staticmethod
    def _payload(g):
        from nanocaller_tpu_torch.pileup.snp_features import (
            SnpGroupFeatures, SnpGroupMember)

        members = []
        for i, m in enumerate(g["members"]):
            B = len(m["cand_site"])
            members.append((i, SnpGroupMember(
                contig=CONTIG, ploidy="diploid", cand_site=m["cand_site"],
                cand_pos32=m["cand_pos32"], nbr_lo=m["nbr_lo"],
                nbr_hi=m["nbr_hi"], deep_idx=m["deep_idx"],
                deep_rids=m["deep_rids"], pos=m["pos"],
                center_ref=m["center_ref"], dp=m["dp"],
                freq=np.zeros(B, np.float32),
                fwd_dp=np.zeros((B, 4), np.int64),
                rev_dp=np.zeros((B, 4), np.int64),
                sampled_depth=m["sampled_depth"],
                nbr_counts=np.zeros((B, 2), np.int64), maxcov=g["maxcov"])))
        wire = {k: g[k] for k in (
            "read_lo", "read_hi", "site_ref", "site_major", "site_minor",
            "minor_bits", "exc_site", "exc_rid", "exc_code", "hole_site",
            "hole_rid", "nbr_pos", "nbr_union")}
        return SnpGroupFeatures(contig=CONTIG, seq_type=g["seq_type"],
                                maxcov=g["maxcov"],
                                n_reads=len(g["read_lo"]), members=members,
                                **wire)

    def enqueue(self, k):
        from nanocaller_tpu_torch.snp_caller import infer_snp_group

        return infer_snp_group(self.state, self.inputs[k], self.pcfg,
                               async_mode=True)

    def finish(self, k, fin, keep=True):
        outs = fin()
        if keep:
            self._keep(k, outs)
        return sum(len(o) for o in outs)

    def reference_probs(self, k, tf32, need=None, block=1024):
        """The reference's (B, 4) probabilities of input k, one array a
        member; `need` (a dict) gets K3's counts by cohort ("normal",
        "deep")."""
        g = self.groups[k]
        dev = self.device
        tree, train_cov = load_pack(self.root, self.cfg["snp_pack"])
        p = reference.to_device(tree, dev)
        tab = reference.GroupTables(g, dev)
        bands = self.cfg["neighbour_bands"]
        outs = []
        t = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a)).to(
            device=dev, dtype=dt)
        for m in g["members"]:
            B = len(m["cand_site"])
            cov = float(np.mean(m["sampled_depth"])) if B else 0.0
            norm = np.float32(train_cov / cov if cov > 0 else 1.0)
            out = np.zeros((B, 4), np.float32)
            deep = np.zeros(B, bool)
            deep[m["deep_idx"]] = True
            for cohort, rows in (("normal", np.flatnonzero(~deep)),
                                 ("deep", np.flatnonzero(deep))):
                for lo in range(0, len(rows), block):
                    r = rows[lo:lo + block]
                    rids = None
                    if cohort == "deep":
                        j = np.searchsorted(m["deep_idx"], r)
                        rids = t(m["deep_rids"][j])
                    x, ref, nd = reference.snp_pileup(
                        tab, bands, t(m["cand_site"][r]),
                        t(m["cand_pos32"][r]), t(np.full(len(r), m["nbr_lo"])),
                        t(np.full(len(r), m["nbr_hi"])),
                        torch.full((len(r),), float(norm), device=dev),
                        rids)
                    with reference.precision(tf32):
                        out[r] = reference.snp_cnn(p, x, ref).cpu().numpy()
                    if need is not None:
                        c = need.setdefault(cohort, {"rows": 0})
                        c["rows"] += len(r)
                        for key, v in nd.items():
                            c[key] = c.get(key, 0) + v
            outs.append(out)
        return outs

    def k3_launches(self, k, need):
        """[(bytes, int32 ops)] of input k's K3 launches (one a cohort)."""
        g = self.groups[k]
        dims = {"N": len(g["read_lo"]), "S": len(g["site_ref"]),
                "T": len(g["minor_bits"]), "E": len(g["exc_rid"]),
                "H": len(g["hole_rid"]), "M": len(g["nbr_pos"])}
        bands = self.cfg["neighbour_bands"]
        n_bands = sum(1 for side in ("left", "right")
                      for b in bands[side] if b[2] > 0)
        out = []
        for cohort in ("normal", "deep"):
            c = need.get(cohort)
            if not c or not c["rows"]:
                continue
            B = c["rows"]
            out.append((work.k3_bytes(dims, B, self.cfg["maxcov"]
                                      if cohort == "deep" else 0),
                        work.k3_ops(c, B, n_bands, dims["M"])))
        return out
