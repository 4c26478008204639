"""Multi-GPU and multi-process execution: the sharded scan (``sharded``)
and its ``torch.distributed`` runner (``multihost``)."""
