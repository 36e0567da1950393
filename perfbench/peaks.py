"""Published peak of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power
limit (NVIDIA's data sheet): the memory bandwidth the kernel rooflines
are held to."""

HBM_BYTES_PER_S = 3.35e12
