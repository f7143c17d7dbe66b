"""Row halos of a shard (ptdn_tpu/parallel/halo.py).

A stencil on a shard's rows reads rows of the shards above and below it:
the à-trous level's taps reach 2 << level rows (64 at level 5, more than
a shard holds when many shards split a short image), the still frame's
back-projection 2, native mode's spatial variance 3. halo_rows fetches
them in as many hops as the halo spans, one group.shift (the JAX
package's lax.ppermute) a hop and direction: whole slabs from the nearer
shards, and from the farthest only the rows the halo reaches (all a
one-hop halo moves). Rows past the image's first and last rows come
back as zeros; the kernels mask every tap by its global row, so they
never weigh.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _rows(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def halo_rows(group, slabs: List[torch.Tensor],
              halo: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """For each held shard's slab (h, ...) of `slabs`: (top, bottom), the
    `halo` image rows above and below it, (halo, ...) each, zeros past
    the image, as two lists over the held shards. A one-hop halo is the
    neighbour's rows as its group gives them (the in-process group's:
    views of the neighbours' slabs, no copy); a halo of 0 rows moves
    nothing."""
    if halo == 0:
        none = [s[:0] for s in slabs]
        return none, none
    h = slabs[0].shape[0]
    hops = -(-halo // h)
    far = halo - (hops - 1) * h       # the rows of the farthest shard
    # above[k - 1] is shard i - k's slab, below[k - 1] shard i + k's
    above = [group.shift(slabs, k) for k in range(1, hops)]
    above.append(group.shift([s[h - far:] for s in slabs], hops))
    below = [group.shift(slabs, -k) for k in range(1, hops)]
    below.append(group.shift([s[:far] for s in slabs], -hops))
    # the image's row order above the shard: i - hops, ..., i - 1
    tops = [_rows([a[j] for a in reversed(above)])
            for j in range(len(slabs))]
    bottoms = [_rows([b[j] for b in below]) for j in range(len(slabs))]
    return tops, bottoms
