"""The plain reference: the CIS565 scene grammar, a path tracer and the
history-residual train step in plain PyTorch. It imports nothing of the
program."""
