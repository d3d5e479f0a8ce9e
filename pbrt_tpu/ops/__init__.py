"""Hot-path kernels.

``fused_path`` runs the whole bounce loop of small diffuse scenes as one
Pallas kernel (through Triton, on the GPU); ``fastgather`` holds the
row-gather helpers the XLA paths share.
"""
