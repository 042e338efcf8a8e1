"""Where the wall time of ``chip_smoke.py`` goes, by phase and by Python line.

    python3 chip_smoke_stacks.py [OUT.json]      (default: build/stack_samples.json)

Runs ``chip_smoke.main()`` (its lines go to stdout as usual) with a thread that reads the
main thread's Python stack every 0.2 s. Each sample is counted under its phase (the
innermost ``phase_*`` frame) and three frames: the innermost one, the innermost one in
``goal_force_tpu_torch`` and the innermost one in ``chip_smoke.py``. Host work shows as
its own lines (numpy, file writes); time on the card shows where the host waits for it
(a synchronising copy, ``.item()``, ``torch.cuda.synchronize``). OUT.json holds, per
phase, its samples and its 25 most frequent (count, innermost, package, smoke) rows.
"""
import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PERIOD_S = 0.2


def _where(stack, key):
    for fn, line, name in stack:
        if key in fn:
            return f"{os.path.basename(fn)}:{line}:{name}"
    return "-"


def sample(main_id, stop, counts):
    while not stop.is_set():
        frame = sys._current_frames().get(main_id)
        stack = []
        while frame is not None:
            stack.append((frame.f_code.co_filename, frame.f_lineno, frame.f_code.co_name))
            frame = frame.f_back
        if stack:
            phase = next((n for _, _, n in stack if n.startswith("phase_")), "-")
            counts[(phase, _where(stack, ""), _where(stack, "goal_force_tpu_torch"),
                    _where(stack, "chip_smoke.py"))] += 1
        time.sleep(PERIOD_S)


def report(counts):
    phases = collections.Counter()
    for (phase, *_), n in counts.items():
        phases[phase] += n
    return {phase: {"samples": n, "seconds": round(n * PERIOD_S, 1),
                    "top": [(c, *key[1:]) for key, c in counts.most_common()
                            if key[0] == phase][:25]}
            for phase, n in phases.most_common()}


def main(out):
    counts, stop = collections.Counter(), threading.Event()
    thread = threading.Thread(target=sample, args=(threading.main_thread().ident, stop, counts),
                              daemon=True)
    thread.start()
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        thread.join()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(report(counts), fh, indent=1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "build",
                                                                        "stack_samples.json")))
