"""K7: MiniBatchKMeans' step (K1a with K7a, the Sculley update, as the
epilogue of its last launch: ``mbk_step``) and a whole epoch of minibatch
steps (K7b ``mbk_epoch``).

K7a replaces the tail of ``dask_ml_tpu/cluster/minibatch_kmeans.py ::
_mbk_step_fn`` (the Kahan add of the batch mass into the (2, k) (hi, lo)
pair and Sculley's move ``c += (bsum − bmass·c)·inv``), after K1a
(``ops/lloyd.py :: lloyd_assign_reduce``) has made the batch's sums.  It
moves k·d floats, too few for a launch of its own: it runs in K1a's last
launch (``csrc/lloyd.cu :: lloyd_assign_reduce_update``: the thread that
sums element (c, j) over K1a's block records moves it), with the bits of
K1a followed by K7a's update.  K7b replaces
``_mbk_epoch_fn``, the ``lax.scan`` of steps over contiguous windows; its
CUDA source is ``csrc/minibatch.cu``.  K7b's steps are a serial chain (each
needs the last one's centres), so its floor is the latency of a step, not
the epoch's 6.09 ms of bytes at 100M x 50.  Its design: one 16-CTA
thread-block cluster runs the epoch, a CTA a sixteenth of each window and
the owner of one centre, the next windows' rows in flight; the assign takes
two rows a thread and four threads a pair; the reduce a column a lane; the
step's exchange pushes each partial into its centre's owner CTA and each
moved centre into every CTA (``st.async`` into distributed shared memory,
signalled on mbarriers), with no cluster barrier.  What still holds it
back: a step is still a chain of four phases of shared-memory traffic,
shuffles and barriers on 16 SMs.

Each wrapper runs its plain PyTorch version (``*_ref``) on a CPU tensor and
launches its kernels on a CUDA tensor, or raises; each counts its launches
in ``<wrapper>.launches``.  K7b takes k ≤ 16 centres and d ≤ 255 features
on a card that can place a 16-CTA cluster; past that ``mbk_epoch`` steps
the epoch through ``mbk_step``, a call a window (``mbk_epoch.stepped``
counts such epochs).  The state is never updated in place: each call
returns new centres and a new pair.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, lloyd
from .lloyd import lloyd_assign_reduce_ref

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_NOT_TAKEN = -1  # mbk_epoch's code where K7b does not take the shape
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("minibatch")
        lib.mbk_epoch.argtypes = [_VP, _VP, _LL, _INT, _INT, _VP, _VP, _LL, _LL, _LL, _VP,
                                  _VP, _VP, _VP]
        lib.mbk_epoch.restype = _INT
        lib.minibatch_error_string.argtypes = [_INT]
        lib.minibatch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.minibatch_error_string(err).decode()})")


def _float32(**named):
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_state(centers, counts):
    k = centers.shape[0]
    if centers.ndim != 2 or tuple(counts.shape) != (2, k):
        raise ValueError(f"centers must be (k, d) and counts (2, k), got "
                         f"{tuple(centers.shape)} and {tuple(counts.shape)}")
    if k == 0 or centers.shape[1] == 0:
        raise ValueError("centers must be non-empty")


def mbk_update_ref(sums, bmass, centers, counts):
    """Plain version of K7a: ``(new_centers (k, d), new_counts (2, k))``.

    The Kahan pair, as the reference: y = bmass + lo, t = hi + y,
    lo = y − (t − hi), hi = t; inv = 1/max(hi + lo, float32 tiny), or 0
    where the mass is 0."""
    hi, lo = counts[0], counts[1]
    y = bmass + lo
    t = hi + y
    lo = y - (t - hi)
    hi = t
    mass = hi + lo
    tiny = torch.finfo(torch.float32).tiny
    inv = torch.where(mass > 0, 1.0 / torch.clamp_min(mass, tiny), torch.zeros_like(mass))
    new_centers = centers + (sums - bmass[:, None] * centers) * inv[:, None]
    return new_centers, torch.stack([hi, lo])


def mbk_step_ref(centers, counts, xb, mask):
    """Plain version of :func:`mbk_step`: K1a's plain version, then K7a's."""
    sums, bmass, inertia = lloyd_assign_reduce_ref(xb, mask, centers)
    new_centers, new_counts = mbk_update_ref(sums, bmass, centers, counts)
    return new_centers, new_counts, inertia


def mbk_step(centers, counts, xb, mask):
    """One Sculley step of the state ``centers`` (k, d) and ``counts`` (2, k)
    on the batch ``xb`` (n, d) weighted by ``mask`` (n,): K1a's weighted
    sums, masses and inertia, with K7a's update in K1a's last launch;
    returns ``(new_centers, new_counts, inertia)``.  On CUDA ``xb`` must
    start on a 16-byte boundary."""
    _float32(centers=centers, counts=counts)
    _check_state(centers, counts)
    if counts.device != centers.device:
        raise ValueError(f"counts is on {counts.device}, centers on {centers.device}")
    if xb.device.type == "cpu":
        return mbk_step_ref(centers, counts, xb, mask)
    n, d, k = lloyd._validate(xb, mask, centers)
    if xb.device.type != "cuda":
        raise ValueError(f"mbk_step runs on cuda or cpu, not {xb.device}")
    lloyd._check_aligned(xb)
    lib = lloyd._load()
    with torch.cuda.device(xb.device):
        out = torch.empty(k * d + k + 1, dtype=torch.float32, device=xb.device)
        new_centers = torch.empty_like(centers)
        new_counts = torch.empty_like(counts)
        plan, scratch = lloyd._plan(lib, "lloyd_plan", 8, n, d, k, xb.device)
        err = lib.lloyd_assign_reduce_update(
            xb.data_ptr(), mask.data_ptr(), centers.data_ptr(), counts.data_ptr(), n, d, k,
            plan, scratch.data_ptr(), out.data_ptr(), new_centers.data_ptr(),
            new_counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    lloyd._check(lib, err, "lloyd_assign_reduce_update")
    mbk_step.launches += 1
    return new_centers, new_counts, out[-1]


def window_start(start, i, bs, n):
    """The first row of step ``i``'s window: (start + i·bs) mod max(n − bs + 1, 1)
    over the ``n`` padded rows, as the reference's epoch."""
    return (int(start) + i * int(bs)) % max(int(n) - int(bs) + 1, 1)


def mbk_epoch_ref(centers, counts, x, mask, start, bs, n_batches):
    """Plain version of K7b: ``n_batches`` plain steps over the windows;
    returns ``(centers, counts, mean step inertia)``."""
    n = x.shape[0]
    inertias = []
    for i in range(int(n_batches)):
        off = window_start(start, i, bs, n)
        centers, counts, inertia = mbk_step_ref(centers, counts, x[off:off + bs],
                                                mask[off:off + bs])
        inertias.append(inertia)
    return centers, counts, torch.mean(torch.stack(inertias))


def _stepped_epoch(centers, counts, x, mask, start, bs, n_batches):
    """An epoch on the card past K7b's shapes: each window copied to a
    16-byte boundary, then ``mbk_step``."""
    n = x.shape[0]
    inertias = []
    for i in range(int(n_batches)):
        off = window_start(start, i, bs, n)
        centers, counts, inertia = mbk_step(centers, counts, x[off:off + bs].clone(),
                                            mask[off:off + bs].contiguous())
        inertias.append(inertia)
    mbk_epoch.stepped += 1
    return centers, counts, torch.mean(torch.stack(inertias))


def mbk_epoch(centers, counts, x, mask, start, bs, n_batches):
    """One epoch of ``n_batches`` Sculley steps over the ``bs``-row windows
    of the padded rows ``x`` (n, d), weighted by ``mask`` (n,), from the
    window at ``start``; returns ``(centers, counts, mean step inertia)``.

    On CUDA ``x`` must start on a 16-byte boundary (the kernel copies 16
    bytes at a time)."""
    _float32(centers=centers, counts=counts, x=x, mask=mask)
    _check_state(centers, counts)
    n, d = x.shape
    k = centers.shape[0]
    bs, n_batches = int(bs), int(n_batches)
    if centers.shape[1] != d or tuple(mask.shape) != (n,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
                         f"centers {tuple(centers.shape)}")
    if not 1 <= bs <= n or n_batches < 1:
        raise ValueError(f"need 1 <= bs <= n and n_batches >= 1, got bs={bs}, n={n}, "
                         f"n_batches={n_batches}")
    for t in (counts, x, mask):
        if t.device != centers.device:
            raise ValueError(f"every operand must be on {centers.device}")
    if x.device.type == "cpu":
        return mbk_epoch_ref(centers, counts, x, mask, start, bs, n_batches)
    if x.device.type != "cuda":
        raise ValueError(f"mbk_epoch runs on cuda or cpu, not {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel copies 16 bytes at "
                         "a time)")
    lib = _load()
    with torch.cuda.device(x.device):
        new_centers = torch.empty_like(centers)
        new_counts = torch.empty_like(counts)
        inertia = torch.empty(1, dtype=torch.float32, device=x.device)
        err = lib.mbk_epoch(x.data_ptr(), mask.data_ptr(), n, d, k, centers.data_ptr(),
                            counts.data_ptr(), int(start), bs, n_batches,
                            new_centers.data_ptr(), new_counts.data_ptr(), inertia.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if err == _NOT_TAKEN:
        return _stepped_epoch(centers, counts, x, mask, start, bs, n_batches)
    _check(lib, err, "mbk_epoch")
    mbk_epoch.launches += 1
    return new_centers, new_counts, inertia[0]


mbk_step.launches = 0
mbk_epoch.launches = 0
mbk_epoch.stepped = 0
