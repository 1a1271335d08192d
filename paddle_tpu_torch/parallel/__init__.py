"""Training parallelism of the port on ``torch.distributed``: the PADDLE_*
env contract (``env``), the rank grid (``mesh``), the communication
levers (``comm_opt``), the dp x pp x tp GPT step (``parallelize``), the
supervising launcher (``launch``), remat policies (``remat``), crash-safe
elastic checkpoints (``checkpoint``), in-run health (``health``) and ring
attention (``ring_attention``). ``sharding/`` is still to be ported
(ROADMAP.md, A3 (a))."""
