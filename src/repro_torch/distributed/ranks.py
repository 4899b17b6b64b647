"""Local ranks for the port's collectives.

:func:`process_group` initialises this process as one rank of a
``world_size``-rank default group over a ``FileStore`` (no port, no
network: several groups can run side by side on one host) and destroys
it on the way out, also on an error.  The backend is NCCL on the card and
gloo on the CPU; the card is the default, and NCCL binds the rank's card
(``device_id``) so that a failure to initialise shows at once.

:func:`run_ranks` runs a top-level function on ``world_size`` spawned
local processes, each a rank of one such group, and returns each rank's
return value (passed back through ``torch.save`` files in a temporary
directory).  A rank that raises, or a run past ``timeout``, ends every
rank and raises here with the first traceback.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device


@contextlib.contextmanager
def process_group(rank: int, world_size: int, store_dir: str, device=None):
    """Rank ``rank`` of a ``world_size``-rank default group whose store is
    a file in ``store_dir`` (empty, shared by every rank); on the card
    (the default) over NCCL with card ``rank % device_count`` bound, with
    ``device="cpu"`` over gloo."""
    device = resolve_device(device)
    kw = {}
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size,
                            **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank: int, world_size: int, tmp: str, device) -> None:
    if resolve_device(device).type == "cpu":
        # every rank's intra-op pool on the same cores would oversubscribe
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        with process_group(rank, world_size, tmp, device):
            out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.part"))
        os.replace(os.path.join(tmp, f"rank{rank}.part"),
                   os.path.join(tmp, f"rank{rank}.pt"))
        code = 0
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    # the result is on disk: leave without the interpreter's teardown, in
    # which a rank under load has been seen to linger for tens of seconds
    os._exit(code)


def run_ranks(fn, world_size: int, *args, device=None,
              timeout: float = 60.0) -> list:
    """``fn(*args)`` on ranks ``0 .. world_size - 1`` (each reads its rank
    from ``torch.distributed.get_rank()``); returns their return values
    in rank order.  ``fn`` must be a module-level function: the ranks
    are spawned and import it afresh.  A rank is done when its result
    file is written; a rank that raised or died, or ``timeout`` seconds,
    ends the run."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        # through a file, not the spawn pipe: a start blocks on writing
        # more than the pipe holds until its child has imported torch
        torch.save(args, os.path.join(tmp, "args.pt"))
        results = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, tmp, device),
                             daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while not all(map(os.path.exists, results)):
                dead = [r for r, p in enumerate(procs) if p.exitcode
                        is not None and not os.path.exists(results[r])]
                if dead or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        missing = [r for r in range(world_size)
                   if not os.path.exists(results[r])]
        if missing:
            errors = [open(os.path.join(tmp, f)).read()
                      for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            raise RuntimeError(
                f"ranks {missing} gave no result (a rank failed, or "
                f"{timeout} s passed)\n" + (errors[0] if errors else ""))
        return [torch.load(f, weights_only=False) for f in results]
