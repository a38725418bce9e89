"""Graph mirrors and the device kernels with their plain versions."""
