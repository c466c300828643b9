"""The (dp, rp) mesh over the ranks of a torch.distributed group (JAX
parallel/): ``launch`` starts the ranks, ``mesh`` shards the k-assignment
and the multi-start solve over them."""
