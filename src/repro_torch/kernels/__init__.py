"""Hopper kernels of the port, their plain PyTorch versions and the router
(:mod:`repro_torch.kernels.ops`).  Importing builds nothing."""
