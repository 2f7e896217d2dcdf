"""Region list + chunk planning.

Reproduces the reference's region semantics (utils.py:6-83): contig
selection from --regions/--bed/--wgs_contigs or the BAM header, ploidy
tagging (chrY/chrM always haploid, chrX via --haploid_X, everything via
--haploid_genome), and the chunk-size policy
min(max_chunk, max(min_chunk, total/cpu+1)).
"""

from __future__ import annotations


def get_regions_list(cfg, bam):
    """Returns list of (contig, start, end, ploidy) with 1-based inclusive
    coordinates, exactly like utils.py:6-63."""
    default_ploidy = "haploid" if cfg.haploid_genome else "diploid"
    regions = []
    if cfg.wgs_contigs:
        for contig in list(range(1, 23)) + ["X", "Y"]:
            name = ("chr" + str(contig)) if cfg.wgs_contigs == "chr1-22XY" else str(contig)
            if bam.is_valid_reference_name(name):
                regions.append([name, 1, bam.get_reference_length(name), default_ploidy])
    elif cfg.regions:
        for r in cfg.regions:
            parts = r.split(":")
            if len(parts) == 1:
                if bam.is_valid_reference_name(parts[0]):
                    regions.append([parts[0], 1, bam.get_reference_length(parts[0]), default_ploidy])
            elif len(parts) == 2:
                cord = parts[1].split("-")
                if len(cord) == 2:
                    regions.append([parts[0], int(cord[0]), int(cord[1]), default_ploidy])
    elif cfg.bed:
        with open(cfg.bed) as fh:
            for line in fh:
                f = line.rstrip("\n").split()
                if f and bam.is_valid_reference_name(f[0]):
                    regions.append([f[0], int(f[1]), int(f[2]), default_ploidy])
    else:
        for name in bam.references:
            regions.append([name, 1, bam.get_reference_length(name), default_ploidy])

    if not regions:
        raise ValueError("no valid regions found")

    for rg in regions:
        if rg[0] in ("chrY", "Y", "chrM", "M"):
            rg[3] = "haploid"
        elif rg[0] in ("chrX", "X"):
            rg[3] = "haploid" if cfg.haploid_X else "diploid"
    return [tuple(r) for r in regions]


def get_chunks(regions_list, cpu, max_chunk_size=500000, min_chunk_size=10000):
    """Chunk policy parity with utils.py:67-83 (1-based inclusive)."""
    chunks = []
    total = sum(r[2] - r[1] + 1 for r in regions_list)
    chunksize = min(max_chunk_size, max(min_chunk_size, total // max(1, cpu) + 1))
    for contig, start, end, ploidy in regions_list:
        for cs in range(start, end, chunksize):
            chunks.append({
                "chrom": contig,
                "start": cs,
                "end": min(end, cs + chunksize),
                "ploidy": ploidy,
            })
    return chunks


def group_adjacent_chunks(ordered_chunks, todo, span_cap):
    """Pack coordinate-adjacent pending chunks into shared-decode groups
    (one decoded window per group; see pileup.snp_features._scan_group).
    Groups never span contigs, gaps (e.g. chunks completed by --resume),
    or ploidy changes, and accumulate at most span_cap bases. Returns a
    list of groups, each a list of (idx, chunk)."""
    groups = []
    cur = []
    cur_span = 0
    for i in todo:
        c = ordered_chunks[i]
        span = c["end"] - c["start"] + 1
        if cur:
            prev = cur[-1][1]
            # chunker emits start == previous end (1-based overlap-by-one
            # parity quirk); plain disjoint adjacency groups just as well.
            # sam_path/tags_path must match too: a group decodes from
            # members[0]'s source only
            adjacent = (c["chrom"] == prev["chrom"]
                        and prev["end"] <= c["start"] <= prev["end"] + 1
                        and c.get("ploidy") == prev.get("ploidy")
                        and c.get("sam_path") == prev.get("sam_path")
                        and c.get("tags_path") == prev.get("tags_path"))
            if not adjacent or cur_span + span > span_cap:
                groups.append(cur)
                cur, cur_span = [], 0
        cur.append((i, c))
        cur_span += span
    if cur:
        groups.append(cur)
    return groups
