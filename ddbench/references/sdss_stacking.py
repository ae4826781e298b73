"""Plain reference for the SDSS stacking configurations (Raicu et al. 2008,
§5): the catalog's content, each request's coadd, and the lower-precision
control that is put in the program's place to show the check can fail.

It imports torch and numpy only: nothing of the program.  What it knows of
the program's semantics it states here, as the application defines them:

  * a file ``img{i}`` holds ``tiles_per_file`` tiles of ``tile_h`` x
    ``tile_w`` fp32 pixels;
  * a request coadds every tile of its files: each tile is calibrated,
    ``(roi - sky) * cal`` with ``sky`` a tenth of the tile's mean and
    ``cal`` 1, shifted by a sub-pixel (dy, dx) with bilinear weights over
    the tile and its copies one pixel down, right and down-right (row 0 and
    column 0 repeat at the edge), and the shifted tiles are averaged;
  * the shifts are drawn, as fp32, from numpy's ``default_rng([1, *ids])``
    over the request's file ids: first every dy, then every dx.

The store is one block of ``store_tiles`` tiles made from the run's seed
on the card, ``CHUNK_TILES`` tiles to a ``torch.Generator`` seed, and
copied to pageable host memory.  File ``i`` is ``tiles_per_file``
consecutive tiles of it, from an offset that a permutation drawn from the
seed gives each file, distinct for every file: files overlap, and no two
are the same.  So a file of the paper's size costs the block's set-up, not
its own, and any file can be made again from the seed and its id.
"""
from __future__ import annotations

import time

import numpy as np
import torch

#: tiles made by one generator call
CHUNK_TILES = 8192
#: requests compared at once, in float64
CHECK_BLOCK = 16


def geometry(cfg: dict) -> tuple[int, int, int]:
    return cfg["tiles_per_file"], cfg["tile_h"], cfg["tile_w"]


def chunk_seed(seed: int, chunk: int) -> int:
    """The generator seed of one chunk of the store, from the run's seed."""
    words = np.random.SeedSequence([seed % (1 << 64), chunk])
    return int(words.generate_state(1, np.uint64)[0])


def make_store(cfg: dict, seed: int, device: torch.device,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The store's block: (store_tiles, H, W) fp32, normal(500, 100), made
    on ``device`` chunk by chunk and written into ``out`` (a tensor of that
    shape, anywhere) or into a new tensor on ``device``."""
    _, h, w = geometry(cfg)
    n = int(cfg["store_tiles"])
    if out is None:
        out = torch.empty((n, h, w), dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    for c, lo in enumerate(range(0, n, CHUNK_TILES)):
        hi = min(lo + CHUNK_TILES, n)
        g.manual_seed(chunk_seed(seed, c))
        made = torch.randn((hi - lo, h, w), generator=g, device=device)
        out[lo:hi].copy_(made.mul_(100.0).add_(500.0))
        del made
    return out


def offsets(cfg: dict, seed: int, n_files: int) -> np.ndarray:
    """The store offset (in tiles) of files ``0 .. n_files - 1``; a file's
    offset does not depend on ``n_files``."""
    t, _, _ = geometry(cfg)
    slots = int(cfg["store_tiles"]) - t + 1
    if n_files > slots:
        raise ValueError(f"{n_files} files need a store of at least "
                         f"{n_files + t - 1} tiles")
    rng = np.random.default_rng([seed % (1 << 64), 2])
    return rng.permutation(slots)[:n_files]


def make_catalog(cfg: dict, n_files: int, seed: int,
                 device: torch.device) -> list[torch.Tensor]:
    """Every file as a (T, H, W) view of one pageable host block, the
    store made on ``device`` and copied down."""
    t, h, w = geometry(cfg)
    host = torch.empty((int(cfg["store_tiles"]), h, w), dtype=torch.float32)
    make_store(cfg, seed, device, out=host)
    return [host[o:o + t] for o in offsets(cfg, seed, n_files).tolist()]


def file_ids(oids) -> list[int]:
    return [int(oid[3:]) for oid in oids]


def shifts(ids, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(dy, dx), each ``n`` fp32 values, of a request over files ``ids``."""
    rng = np.random.default_rng([1, *ids])
    dy = rng.random(n).astype(np.float32)
    dx = rng.random(n).astype(np.float32)
    return dy, dx


def coadd(tiles: torch.Tensor, dy: torch.Tensor,
          dx: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W) tiles and (B, N) shifts -> (B, H, W) coadds, computed in
    the tiles' dtype."""
    _, _, h, w = tiles.shape
    sky = tiles.mean(dim=(2, 3)) * 0.1
    cal = torch.ones_like(sky)
    img = (tiles - sky[..., None, None]) * cal[..., None, None]
    up = (torch.arange(h, device=tiles.device) - 1).clamp(min=0)
    left = (torch.arange(w, device=tiles.device) - 1).clamp(min=0)
    above = img[:, :, up, :]
    dy = dy[..., None, None]
    dx = dx[..., None, None]
    out = ((1 - dy) * ((1 - dx) * img + dx * img[:, :, :, left])
           + dy * ((1 - dx) * above + dx * above[:, :, :, left]))
    return out.sum(dim=1) / tiles.shape[1]


def worst_error(cfg: dict, seed: int, requests: list[tuple[tuple, object]],
                device: torch.device) -> float:
    """The largest, over ``requests`` ((file oids, the program's output)),
    of max|output - reference| / max|reference|, with the reference computed
    in float64 from the seed.  An output that is not an (H, W) fp32 tensor
    on ``device`` reads ``inf``."""
    if not requests:
        return 0.0
    t, h, w = geometry(cfg)
    ids = [f for oids, _ in requests for f in file_ids(oids)]
    at = offsets(cfg, seed, max(ids) + 1)
    store = make_store(cfg, seed, device)
    worst = 0.0
    for lo in range(0, len(requests), CHECK_BLOCK):
        block = requests[lo:lo + CHECK_BLOCK]
        ok = [isinstance(out, torch.Tensor) and tuple(out.shape) == (h, w)
              and out.dtype == torch.float32 and out.device == device
              for _, out in block]
        if not all(ok):
            return float("inf")
        fids = [file_ids(oids) for oids, _ in block]
        tiles = torch.stack([
            torch.cat([store[at[f]:at[f] + t] for f in fs]) for fs in fids])
        n = tiles.shape[1]
        sh = np.stack([np.stack(shifts(fs, n)) for fs in fids])
        sh = torch.from_numpy(sh).to(device=device, dtype=torch.float64)
        want = coadd(tiles.double(), sh[:, 0], sh[:, 1])
        got = torch.stack([out for _, out in block]).double()
        err = ((got - want).abs().amax(dim=(1, 2))
               / want.abs().amax(dim=(1, 2)))
        worst = max(worst, float(err.max()))
    return worst


def control_task(cfg: dict):
    """The reference in the program's place, computed in bfloat16 (the
    precision below the configuration's fp32): a task function taking the
    runtime's ``{oid: device tensor}`` inputs, holding its executor for the
    configuration's host time first, as the program's task does."""
    host_s = cfg["host_s_per_request"]

    def task(inputs):
        if host_s:
            time.sleep(host_s)
        tiles = torch.cat(list(inputs.values()), dim=0)
        n = tiles.shape[0]
        dy, dx = (torch.from_numpy(s).to(tiles.device, torch.bfloat16)
                  for s in shifts(file_ids(inputs), n))
        out = coadd(tiles.to(torch.bfloat16)[None], dy[None], dx[None])
        return out[0].float()

    return task
