"""Models of the port: GPT (``gpt``), the ERNIE/BERT encoder (``ernie``),
the fluid ResNet family (``resnet``) and the fluid transformer encoder
(``transformer_encoder``); the rest of the fluid model zoo is still to be
ported (ROADMAP.md, queue A)."""
