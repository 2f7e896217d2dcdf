"""Training: torch autograd and Adam, reproducing the reference's losses
(the port of nanocaller_tpu/train/). The SNP and indel steps
(snp_train, indel_train), their host data (data, indel_data) and the
training CLIs (`python -m nanocaller_tpu_torch.train.train_snp`,
`... .train_indel`)."""
