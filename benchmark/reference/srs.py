"""The KZG trapdoor s from a configuration's fixed SRS seed.  The SRS is a
deployment constant, not traffic: the benchmark hands s to the program's
`ParamsKZG.setup`, and the reference works the verifying key out from it."""

import hashlib

from .bn254 import FR


def srs_secret(seed: int) -> int:
    digest = hashlib.blake2b(seed.to_bytes(16, "little"), digest_size=64,
                             person=b"bench-srs-seed").digest()
    return int.from_bytes(digest, "little") % (FR.p - 1) + 1
