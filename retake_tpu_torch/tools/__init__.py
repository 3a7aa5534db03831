"""Scripts of the port: kernel and arm timing (run on a CUDA card) and the
checkpoint quantizer."""
