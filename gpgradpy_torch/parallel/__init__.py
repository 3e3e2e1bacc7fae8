"""Multi-device layer over torch.distributed (counterpart of
``gpgradpy_tpu/parallel``): the mesh of ranks, the sharded matvec and the
distributed Cholesky."""
