"""Measurement probes: the counterparts of ``scripts/microbench*.py``.

Each module holds one hand-written CUDA kernel (the port of the probe's
Pallas kernel), its plain PyTorch version and the probe's entry point,
which times them on the card:

  conv3        k=3^3 SAME 3D conv at V2V 64^3 shapes (microbench_pallas_conv.py)
  sw_variants  slice-warp forward ablation modes (microbench_sw_variants.py)
  primitives   one primitive repeated on an on-chip tile, and the V2V,
               transpose and soft-argmax timings beside it (microbench.py)
  common       card line, device rule, CUDA-event timing

    python -m selfpose3d_tpu_torch.microbench.<module>

Nothing on the inference or train path calls these kernels.
"""
