"""Decision: link state, prefix state, the CPU oracle and the GPU solver."""
