"""repro_torch — the PyTorch/CUDA port of the quorum all-pairs system.

It mirrors the JAX package ``repro`` module for module and imports none of
it (nor JAX): the framework-neutral modules are kept as copies, and the P
devices of the reference's ``shard_map`` are a leading ``[P, ...]`` axis
moved by :class:`repro_torch.core.comm.SingleProcessComm`.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
