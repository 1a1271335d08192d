"""Models of the port: GPT (``gpt``), the ERNIE/BERT encoder (``ernie``)
and the fluid ResNet family (``resnet``); the rest of the fluid model zoo
is still to be ported (ROADMAP.md, queue A)."""
