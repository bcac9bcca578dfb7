"""The JAX package's serving engine for the port's tests, with its block
table uploaded from a copy.

``repro.serving.engine.ServingEngine._sync_bt`` uploads the host block
table with ``jnp.asarray`` and edits that same array in place afterwards.
On a jax whose CPU upload completes asynchronously, an edit made before the
upload is done can reach the device copy, and a step then reads pages its
table does not name, now and then (ROADMAP queue 3 item 4).  The subclass
uploads a copy that nothing edits: the same computation without the race,
so the port's engines are held to the same reference tokens on every run.
"""

import jax.numpy as jnp

from repro.serving.engine import ServingEngine


class JEngine(ServingEngine):
    def _sync_bt(self):
        if self._paged and self._bt_dirty:
            self.state = dict(self.state, block_tables=jnp.asarray(self._bt.copy()))
            self._bt_dirty = False
