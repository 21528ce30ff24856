"""Pallas kernels for the GPU (Triton route).

`cluster_kernel` is the block-coherent cluster tracer, the kernel form of
ops/cluster_trace.py. Kernels here compile for the GPU only; the CPU runs
them solely through the Pallas interpreter when a caller passes
`interpret=True`.
"""
