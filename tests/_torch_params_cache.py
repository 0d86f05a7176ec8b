"""An empty IPA params cache for each test module of the port.

`ParamsIPA.new` reads its params from `$HALO2_TPU_CACHE/params` when a
file is there.  A test that holds the port against the reference must
compare params the port made in the run, not a file an earlier run (or the
reference, which writes the same file name) left in a shared cache.  A
module imports `own_params_cache`; being autouse, it points
`HALO2_TPU_CACHE` at a new directory for the whole module, and child
processes inherit it."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def own_params_cache(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HALO2_TPU_CACHE",
                  str(tmp_path_factory.mktemp("params_cache")))
        yield
