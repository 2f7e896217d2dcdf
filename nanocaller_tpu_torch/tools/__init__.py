"""The port's user tools, each a module run with `python -m`:

- `simulate`: a synthetic FASTA, BAM and truth VCF (with `--hp_profile`,
  homopolymer runs, indels inside them and slip errors in the reads);
- `vcf_compare`: precision, recall and F1 of calls against a truth VCF;
- `ensemble`: a majority vote over several callers' VCFs;
- `snp_readnames`: the read names behind each allele of a VCF's SNPs;
- `real_data_eval`: the CLI over the validation configurations, then
  vcf_compare;
- `bench_e2e`: simulate, the CLI's `--mode all`, vcf_compare, in one
  JSON line.

Copies of the JAX package's tools/*.py on the port's modules, with the
same flags; the two that run the CLI take `--device cuda|cpu` (cuda by
default) for the JAX tools' `--platform`.
"""
