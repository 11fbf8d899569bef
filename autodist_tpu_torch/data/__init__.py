"""The input plane: the prefetching device feed."""
