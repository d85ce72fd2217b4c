"""The history of past fakes for the discriminator's update, ``--pool_size``
(``vts_tpu/utils/image_pool.py``).

* :class:`ImagePool`: the host numpy pool, as the reference's: until it is
  full each image is stored and passed through; after that, with
  probability 1/2 an image is swapped with a random stored one (the stored
  one goes to the discriminator), else passed through.
* :func:`pool_query`: the same sequential rule for the training step, the
  pool a tensor on the device.  Its random draws are arguments (one
  uniform and one slot per image), so a step can replay the reference's:
  per image ``k1, k2 = split(k)``, ``uniform(k1)`` and
  ``randint(k2, (), 0, P)``.  The fill count is the same for any draws, so
  it is a host integer; the decisions are made on the host from the draws
  and the device does one gather for the batch and one for the pool.
"""

from __future__ import annotations

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.default_rng(seed)

    def query(self, images) -> np.ndarray:
        """(N, H, W, C) fakes → the same shape, each either the input or a
        stored fake that it replaced."""
        images = np.asarray(images)
        if self.pool_size == 0:
            return images
        out = []
        for img in images:
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.uniform() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                out.append(self.images[idx].copy())
                self.images[idx] = img.copy()
            else:
                out.append(img)
        return np.stack(out)


def pool_query(buf: torch.Tensor, n: int, images: torch.Tensor, u, rid):
    """Run the batch through the pool in order: ``buf`` (P, H, W, C), ``n``
    stored so far, ``images`` (B, H, W, C), ``u`` (B,) uniforms and ``rid``
    (B,) slots in [0, P).  While n < P an image is stored at slot n and
    returned; then, where u > 0.5, it takes slot rid's place and the stored
    image is returned, else it is returned as it is.  → (new buf, new n,
    the (B, H, W, C) batch for the discriminator)."""
    p = buf.shape[0]
    n = int(n)
    rows = list(range(p))            # slot → its row of cat([buf, images])
    picked = []                      # image → the row returned for it
    for i, (ui, ri) in enumerate(zip(torch.as_tensor(u).tolist(),
                                     torch.as_tensor(rid).tolist())):
        if n < p:
            rows[n] = p + i
            n += 1
            picked.append(p + i)
        elif ui > 0.5:
            picked.append(rows[ri])
            rows[ri] = p + i
        else:
            picked.append(p + i)
    both = torch.cat([buf, images.to(buf.dtype)])
    out = both.index_select(0, torch.tensor(rows + picked, device=buf.device))
    return out[:p], n, out[p:]
