#!/usr/bin/env python3
"""Run chip_smoke.py's two artifact phases alone on one card: ResNet-50
served as bench.py's resnet50_serving row serves it
(phase_resnet_artifact_serving: export_compiled at buckets 1/8/32/128 ->
BatchingPredictor; sequential, capacity and Poisson arms, run_batches,
bit-identity and CPU gates) and trained from an export_train_step
artifact (phase_compiled_trainer: CompiledTrainer against Executor.run
and its resume, bf16, batch 64).

    python3 scripts/artifact_serving_phases.py

It builds the kernels and the served ResNet-50 directory as chip_smoke.py
does, with TF32 off, prints the card's name and power limit first and
each phase's own lines, and exits 1 if either phase failed. A run takes
about a minute on an H100 after the build.
"""
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('artifact_serving_phases: this run needs an NVIDIA GPU',
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.set_float32_matmul_precision('highest')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(cs.card_line())
    t0 = time.perf_counter()
    cs.kernels.build()
    print('build all kernels %.1fs' % (time.perf_counter() - t0))
    ok = True
    with tempfile.TemporaryDirectory() as d:
        n_bn, _ = cs.build_and_save(d)
        try:
            print('launches', cs.phase_resnet_artifact_serving(d, n_bn))
        except Exception:  # noqa: BLE001 — report and run the next phase
            traceback.print_exc()
            ok = False
    torch.cuda.empty_cache()
    try:
        print('launches', cs.phase_compiled_trainer())
    except Exception:  # noqa: BLE001 — report, then fail the run
        traceback.print_exc()
        ok = False
    print('%s in %.1f s' % ('passed' if ok else 'FAILED',
                            time.perf_counter() - t0))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
