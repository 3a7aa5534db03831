"""Scripts of the port: kernel and arm timing (run on a CUDA card), the
checkpoint quantizer, the first-checkpoint gate with its stage tools, and
the TTFT / TPOT and trace tools."""
