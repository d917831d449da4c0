"""A frozen plain copy of the port's training step (scene model, soft and
hard renderers, losses), every hand-written kernel replaced by its plain
PyTorch twin. It imports nothing of the port, so a later change to the
port's code is held against this copy, not against itself."""
