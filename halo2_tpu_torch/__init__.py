"""halo2_tpu_torch — the PyTorch / CUDA port of halo2_tpu for one NVIDIA H100.

keygen -> create_proof -> verify run on PyTorch tensors, for KZG on BN254
with the SHPLONK multiopen and for IPA over the Pasta curves (the API's
default, as in the reference), with a Blake2b transcript.  Hand-written
Hopper kernels in `csrc/` carry the device work:

  A  field.cu  field mul / add / sub         (fields/cuda_ops.py)
  B  ec.cu     complete add / madd / double  (curves/cuda_ec.py)
  C  ntt.cu    base Stockham NTT             (ntt/fused.py)
     msm.cu    ordering pass: bucket keys    (msm/stream_msm.py)
  D  msm.cu    baked fixed-base piece sums   (msm/stream_msm.py)
  8  msm.cu    unbaked per-window piece sums (msm/stream_msm.py)
  9  scan.cu   segmented scan, variable base (msm/bucket_scan.py)

and the probes' kernels 10-15 (alu.cu, move.cu; tools/).

Around the prover, as in the reference: key and params serde
(`compat/serde.py`), the middleware contract (`middleware.py`), the IPA
batch verifier (`plonk/batch.py`), the dev tools (`dev/`: MockProver,
cost model, gates, layout, tracing planner) and the examples
(`examples/`).

Each kernel has a plain PyTorch version beside it, taken for CPU tensors.
The package imports no JAX and keeps its own copy of the host code it
needs (frontend/, native/, compat/, msm/host_msm.py, plonk/errors.py).
Entry points run on the card unless the caller names the CPU.
"""

__version__ = "0.2.0"
