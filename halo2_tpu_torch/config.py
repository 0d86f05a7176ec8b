"""Typed run configuration (port of the JAX reference's config.py): one
object that names the curve, commitment scheme and multiopen, transcript
and k, and resolves them to the port's classes, so that callers write

    cfg = ProofConfig(k=18, curve="bn254", scheme="kzg-gwc",
                      transcript="keccak256")
    params = cfg.params()
    pk = cfg.keygen(circuit, params=params)
    proof = cfg.prove(pk, [circuit], [instances], rng, params=params)
    ok = cfg.verify(pk.vk, proof, [instances], params=params)

`device` (default "cuda") is where the params, and so every proof made
with them, live; tests pass "cpu".  With `mesh_devices=n`, keygen and
prove run on a mesh of n devices of that kind (`dist.make_mesh`: cuda:0
.. cuda:n-1, which raises when fewer cards are visible, or n CPU shards):
the NTTs, the fixed-base MSMs and the permutation products are sharded,
and the proof bytes are those of one device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import api
from .commit import (ParamsIPA, ParamsKZG, ProverGWC, ProverIPA,
                     ProverSHPLONK, SingleStrategyIPA, SingleStrategyKZG,
                     VerifierGWC, VerifierIPA, VerifierSHPLONK)
from .curves import BN254_G1, PALLAS, VESTA
from .fields import BN254_FR, PASTA_FP, PASTA_FQ
from .transcript import (Blake2bRead, Blake2bWrite, Keccak256Read,
                         Keccak256Write)

_CURVES = ("pallas", "vesta", "bn254")
_SCHEMES = ("ipa", "kzg-gwc", "kzg-shplonk")
_TRANSCRIPTS = ("blake2b", "keccak256")


@dataclass
class ProofConfig:
    """curve + commitment scheme + multiopen + transcript + k + device."""
    k: int
    curve: str = "bn254"
    scheme: str = "kzg-shplonk"
    transcript: str = "blake2b"
    mesh_devices: Optional[int] = None
    compress_selectors: bool = True
    device: str = "cuda"
    _engine: Optional[object] = field(default=None, init=False, repr=False,
                                      compare=False)

    def __post_init__(self):
        if self.curve not in _CURVES:
            raise ValueError(f"curve must be one of {_CURVES}")
        if self.scheme not in _SCHEMES:
            raise ValueError(f"scheme must be one of {_SCHEMES}")
        if self.transcript not in _TRANSCRIPTS:
            raise ValueError(f"transcript must be one of {_TRANSCRIPTS}")
        if self.scheme.startswith("kzg") and self.curve != "bn254":
            raise ValueError("KZG requires the pairing curve bn254")
        if self.scheme == "ipa" and self.curve == "bn254":
            raise ValueError("IPA params require a hash-to-curve suite "
                             "(pallas/vesta)")

    # -- resolution ------------------------------------------------------

    @property
    def F(self):
        return {"pallas": PASTA_FQ, "vesta": PASTA_FP,
                "bn254": BN254_FR}[self.curve]

    @property
    def curve_obj(self):
        return {"pallas": PALLAS, "vesta": VESTA,
                "bn254": BN254_G1}[self.curve]

    def params(self):
        if self.scheme == "ipa":
            return ParamsIPA.new(self.curve_obj, self.k, device=self.device)
        return ParamsKZG.new(self.k, device=self.device)

    def _classes(self):
        writer, reader = {
            "blake2b": (Blake2bWrite, Blake2bRead),
            "keccak256": (Keccak256Write, Keccak256Read),
        }[self.transcript]
        prover, verifier, strategy = {
            "ipa": (ProverIPA, VerifierIPA, SingleStrategyIPA),
            "kzg-gwc": (ProverGWC, VerifierGWC, SingleStrategyKZG),
            "kzg-shplonk": (ProverSHPLONK, VerifierSHPLONK,
                            SingleStrategyKZG),
        }[self.scheme]
        return writer, reader, prover, verifier, strategy

    def engine(self):
        """The meshed engine of `mesh_devices` devices, built at the first
        call and kept (so are its sharded tables), or None."""
        if self.mesh_devices is None:
            return None
        if self._engine is None:
            from .dist import make_mesh
            from .engine import GpuMsmEngine, PlonkEngineConfig
            mesh = make_mesh(self.mesh_devices, self.device)
            self._engine = PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=mesh))
        return self._engine

    # -- drivers ---------------------------------------------------------

    def keygen(self, circuit, params=None):
        return api.keygen(self.F, params or self.params(), self.k, circuit,
                          compress_selectors=self.compress_selectors,
                          engine=self.engine())

    def prove(self, pk, circuits, instances, rng=None, params=None,
              timings=None) -> bytes:
        writer, _r, prover, _v, _s = self._classes()
        return api.create_proof(params or self.params(), pk, circuits,
                                instances, rng, transcript_cls=writer,
                                multiopen_prover_cls=prover,
                                engine=self.engine(), timings=timings)

    def verify(self, vk, proof: bytes, instances, params=None) -> bool:
        _w, reader, _p, verifier, strategy = self._classes()
        return api.verify(params or self.params(), vk, proof, instances,
                          transcript_cls=reader,
                          multiopen_verifier_cls=verifier,
                          strategy_cls=strategy)
