"""The port's LM substrate (``repro/models``): so far the Mamba2 (SSM)
family — configuration, shared blocks, the Mamba2 block and the LM stack
for layer kind "M"."""
