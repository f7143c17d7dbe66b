"""Row halos of a shard (ptdn_tpu/parallel/halo.py).

A stencil on a shard's rows reads rows of the shards above and below it:
the à-trous level's taps reach 2 << level rows (64 at level 5, more than
a shard holds when many shards split a short image), the still frame's
back-projection 2, native mode's spatial variance 3. halo_rows fetches
them in as many hops as the halo spans, one group.shift (the JAX
package's lax.ppermute) a hop and direction. Rows past the image's first
and last rows come back as zeros; the kernels mask every tap by its
global row, so they never weigh.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def halo_rows(group, slabs: List[torch.Tensor],
              halo: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """For each held shard's slab (h, ...) of `slabs`: (top, bottom), the
    `halo` image rows above and below it, (halo, ...) each, zeros past
    the image, as two lists over the held shards."""
    h = slabs[0].shape[0]
    hops = -(-halo // h)
    # above[k - 1] is shard i - k's slab, below[k - 1] shard i + k's
    above = [group.shift(slabs, k) for k in range(1, hops + 1)]
    below = [group.shift(slabs, -k) for k in range(1, hops + 1)]
    # the image's row order above the shard: i - hops, ..., i - 1
    tops = [torch.cat([a[j] for a in reversed(above)])[-halo:]
            for j in range(len(slabs))]
    bottoms = [torch.cat([b[j] for b in below])[:halo]
               for j in range(len(slabs))]
    return tops, bottoms
