"""The port's probes: kernels 10-15 and the scripts that measure the card's
own rates with them.

  alu_probe.py         kernels 10/11 and 12 (csrc/alu.cu): Montgomery
                       products and u32 multiply-adds in registers
  dma_gather_probe.py  kernel 13 (csrc/move.cu): a gather of table rows
  transpose_probe.py   kernels 14/15 (csrc/move.cu): (R, 16) <-> (16, R)
  ec_census.py         kernels B and 9 (csrc/ec.cu, scan.cu): B's time
                       per launch by batch size, its launches in an IPA
                       prove by caller, kernel 9's calls in that prove
  ntt_census.py        kernel C (csrc/ntt.cu) and the transforms: C's
                       build and pass times, whole transforms, and per
                       path every transform, C launch and the device time
                       inside the transforms
  card.py              the card's rates, CUDA-event timing and the bound
                       of a kernel's work, shared with bench.py and
                       chip_smoke.py

Each probe runs on the card as `python -m halo2_tpu_torch.tools.<probe>`.
"""
