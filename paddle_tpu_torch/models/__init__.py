"""Models of the port. GPT only in this slice; ERNIE and the fluid model
zoo are still to be ported (ROADMAP.md, queue A)."""
