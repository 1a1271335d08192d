"""Training parallelism of the port on ``torch.distributed``: the PADDLE_*
env contract (``env``), the rank grid (``mesh``), the communication
levers (``comm_opt``), the dp x pp x tp GPT step (``parallelize``), the
supervising launcher (``launch``), remat policies (``remat``), crash-safe
elastic checkpoints (``checkpoint``), in-run health (``health``) and ring
attention (``ring_attention``). The sharding plans the step takes
(``sharding=``) are in ``paddle_tpu_torch/sharding``."""
