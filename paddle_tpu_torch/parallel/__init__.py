"""Single-device training of the port: remat policies (``remat``), the
AdamW step (``parallelize``) and the non-finite guard (``health``).
Multi-GPU parallelism is still to be ported (ROADMAP.md, queue A)."""
