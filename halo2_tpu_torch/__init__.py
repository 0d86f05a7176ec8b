"""halo2_tpu_torch — the PyTorch / CUDA port of halo2_tpu for one NVIDIA H100.

The main path of the reference (KZG on BN254 with the SHPLONK multiopen
and a Blake2b transcript: keygen -> create_proof -> verify) runs on PyTorch
tensors, with four hand-written Hopper kernels in `csrc/`:

  A  field.cu  field mul / add / sub       (fields/cuda_ops.py)
  B  ec.cu     G1 complete add/madd/double (curves/cuda_ec.py)
  C  ntt.cu    base Stockham NTT           (ntt/fused.py)
  D  msm.cu    baked fixed-base buckets    (msm/stream_msm.py)

Each kernel has a plain PyTorch version beside it, taken for CPU tensors.
The package imports no JAX; it shares the reference's JAX-free host code
(`halo2_tpu.frontend`, see `_shared.py`).
"""

__version__ = "0.1.0"
