"""Device ops of the port: preprocessing, attention, decode and the CUDA kernels."""
