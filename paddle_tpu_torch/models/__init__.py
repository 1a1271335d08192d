"""Models of the port: GPT (``gpt``) and the ERNIE/BERT encoder
(``ernie``); the fluid model zoo is still to be ported (ROADMAP.md,
queue A)."""
