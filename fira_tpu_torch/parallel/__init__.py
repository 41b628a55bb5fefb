"""Parallelism (the port's ``fira_tpu/parallel``): the training mesh with
data and tensor parallelism (:mod:`fira_tpu_torch.parallel.mesh`), ring
attention for ``seq_shards`` over a mesh's ranks or one process's
devices (:mod:`fira_tpu_torch.parallel.ring`), the
rank jobs that hold a layout against one process
(:mod:`fira_tpu_torch.parallel.jobs`), and the slot-engine fleet of
replicated decode (:mod:`fira_tpu_torch.parallel.fleet`)."""
