"""Training parallelism of the port on ``torch.distributed``: the PADDLE_*
env contract (``env``), the rank grid (``mesh``), the communication
levers (``comm_opt``), the dp x pp x tp GPT step (``parallelize``), the
launcher (``launch``), remat policies (``remat``) and the non-finite
guard (``health``). Ring attention, checkpointing and the rest of
``health`` are still to be ported (ROADMAP.md, A3 (a))."""
