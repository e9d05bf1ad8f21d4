"""Parallelism over ranks, one card each, under ``torch.distributed``
(the JAX package's ``parallel/``):

- ``distributed``  joining the group (a launcher's ``RANK`` /
  ``WORLD_SIZE``, the ``MLOPS_TPU_*`` coordinator contract, or a world of
  one), NCCL on the card and gloo on the CPU, the coordinator predicate;
- ``mesh``         named axes over a grid of ranks, a process group per
  axis;
- ``collectives``  differentiable all-reduce, gather, shard, mean and
  the ``ppermute`` ring shift over an axis;
- ``sharding``     the Megatron partition rules over the port's
  parameter names, a rank's block of a tensor and back;
- ``steps``        the DP x TP train step;
- ``pipeline``     GPipe microbatch streaming over a 'stage' axis;
- ``ring_attention`` exact sequence-parallel attention over a 'seq' axis;
- ``bulk``         bulk scoring, on a data mesh when given (each rank
  copies and scores its block of every chunk).

The submodules are imported where used (the models import the
collectives, and ``steps`` imports the models).
"""
