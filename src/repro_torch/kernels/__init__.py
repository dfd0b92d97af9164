"""FP8 kernels of the port: CUDA sources (``csrc/``), their build and
wrappers (``fp8_quant``), plain twins (``ref``) and the dispatch seam."""
