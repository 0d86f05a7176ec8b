"""Shared by the step readers: the mean over the window's proofs of the
sum of some steps of the prover's step table (`create_proof(timings=)`)."""


def mean_of(r, names):
    if not r.steps or any(n not in s for s in r.steps for n in names):
        return None
    return sum(sum(s[n] for n in names) for s in r.steps) / len(r.steps)
