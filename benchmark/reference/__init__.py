"""The benchmark's plain reference: plain PyTorch, no kernels, no import of
the program. The modules beside ``water.py`` and ``recip.py`` are frozen
copies of admp_tpu_torch's plain modules (ops/, utils/) at commit 70cb951,
with their imports made relative; ``recip.py`` keeps the plain route of
ops/reciprocal.py only."""
