"""Worker process of the port's two-process run (parallel/distributed.py).

Spawned as N OS processes by tests/test_torch_multihost.py (on the CPU)
and by chip_smoke.py phase 5f (on one card, both processes on cuda:0).
Each joins the process group over gloo, feeds only its own slice of the
channels (one synthesized capture, each channel a shift of it), runs them
through `sharded_run` on its part of the job's mesh (4 virtual shards of
its device) and checks its outputs against a serial run of the same
channels.  Nothing crosses processes but the rendezvous.  Imports only
the port, never jax or sdr_tpu.

Usage: python torch_multihost_worker.py <process_id> <num_processes> <port>
           [<device> <channels> <seconds>]
"""

import sys


def main() -> int:
    proc_id, n_proc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    n_ch = int(sys.argv[5]) if len(sys.argv) > 5 else 8
    sec = float(sys.argv[6]) if len(sys.argv) > 6 else 0.02
    import numpy as np
    import torch
    import torch.distributed as tdist

    from sdr_tpu_torch.parallel import distributed as dist

    dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=n_proc, process_id=proc_id, backend="gloo")
    if tdist.get_world_size() != n_proc:
        raise SystemExit(f"world size {tdist.get_world_size()}")

    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.parallel.channels import sharded_run

    cfg = MODES[0]
    n = int(sec * cfg.rf_fs)
    base = tx.synthesize_capture(cfg, seconds=sec, seed=0,
                                 mono=tx.tone(cfg.rf_fs, 400.0, n))
    # per-process feeding: this process makes ONLY its own channels
    lo, hi = dist.local_channel_slice(n_ch)
    local = np.stack([np.roll(base, -2 * 4099 * c) for c in range(lo, hi)])

    mesh = dist.global_channel_mesh(devices=[torch.device(device)] * 4)
    giq = dist.make_global_batch(local, mesh)
    if (giq.offset, giq.n_global) != (lo, n_ch):
        raise SystemExit(f"batch offset {giq.offset} of {giq.n_global}")

    rx = Receiver(0, device=device)
    outs, _ = sharded_run(rx, giq, mesh)
    serial, _ = rx.run(local)
    got, want = outs["mono"].cpu().numpy(), serial["mono"].cpu().numpy()
    if got.shape != (hi - lo, want.shape[-1]):
        raise SystemExit(f"outputs {got.shape}")
    np.testing.assert_allclose(got, want, atol=1e-6)

    print(f"MULTIHOST_OK proc={proc_id}/{tdist.get_world_size()} "
          f"global_devices={mesh.shape['channels']} "
          f"local_devices={len(mesh.devices)} channels={lo}-{hi - 1} "
          f"device={device} max_abs_err={np.abs(got - want).max():.3g}",
          flush=True)
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
