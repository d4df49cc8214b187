"""Hard-example mining sampler (PyTorch-port twin of
uhc_tpu.data.sampling; numpy only).

Reference semantics (uhc/agents/agent_copycat.py:561,590-603 freq_dict +
uhc/data_loaders/dataset_amass_single.py:184-186): every finished episode
logs (success, start-frame) per sequence; sampling probability is
softmax(-ewma(success)/temp) mixed with a uniform draw at rate
(1 - sampling_freq). Here the telemetry arrives as (T, B) arrays from the
rollout (seq_idx/percents/fails at done steps) and the sampler emits a
logits vector consumed by the on-device categorical in the rollout.
"""
from __future__ import annotations

from typing import List

import numpy as np


def ewma(xs: np.ndarray, alpha: float = 0.05) -> float:
    avg = xs[0]
    for x in xs[1:]:
        avg = alpha * x + (1 - alpha) * avg
    return float(avg)


class FailureFrequencySampler:
    def __init__(self, num_seqs: int, sampling_temp: float = 0.2,
                 sampling_freq: float = 0.75, history: int = 200):
        self.num_seqs = num_seqs
        self.temp = sampling_temp
        self.freq = sampling_freq
        self.history = history
        self.records: List[List[float]] = [[] for _ in range(num_seqs)]
        # start frames of FAILED episodes, for precision_mode restarts
        # (freq_dict stores [percent, fr_start] pairs,
        # agent_copycat.py:561; dataset_amass_single.py:222-230 samples
        # new window starts around the recorded failure starts)
        self.fail_starts: List[List[int]] = [[] for _ in range(num_seqs)]

    def update_from_rollout(self, seq_idx, dones, percents, start_inds=None):
        """Ingest (T, B) arrays from a rollout scan."""
        seq_idx = np.asarray(seq_idx).reshape(-1)
        dones = np.asarray(dones).reshape(-1)
        percents = np.asarray(percents).reshape(-1)
        starts = (None if start_inds is None
                  else np.asarray(start_inds).reshape(-1))
        for i, (s, d, p) in enumerate(zip(seq_idx, dones, percents)):
            if d:
                rec = self.records[int(s)]
                rec.append(float(p >= 1.0 - 1e-5))
                if len(rec) > self.history:
                    del rec[0]
                # 1-ulp tolerance as in learn/metrics.py succ
                if starts is not None and p < 1.0 - 1e-5:
                    fs = self.fail_starts[int(s)]
                    fs.append(int(starts[i]))
                    if len(fs) > self.history:
                        del fs[0]

    def fail_start_pool(self, pool_size: int = 64) -> np.ndarray:
        """(S, pool_size) int32 of recorded failure window starts per
        sequence, -1-padded when a sequence has no recorded failures —
        the device-side precision_mode restart pool (rollout.reset_like)."""
        pool = np.full((self.num_seqs, pool_size), -1, np.int32)
        for s, fs in enumerate(self.fail_starts):
            if fs:
                k = min(len(fs), pool_size)
                pool[s, :k] = fs[-k:]
                if k < pool_size:          # cycle so every slot is valid
                    reps = np.resize(np.asarray(fs[-k:], np.int32),
                                     pool_size - k)
                    pool[s, k:] = reps
        return pool

    def success_rates(self) -> np.ndarray:
        return np.array([ewma(np.array(r)) if r else 0.0
                         for r in self.records])

    def logits(self) -> np.ndarray:
        """log-probabilities for the device categorical: the
        softmax(-ewma/temp) distribution mixed with uniform at (1-freq)."""
        x = self.success_rates()
        p = np.exp(-x / self.temp)
        p = p / p.sum()
        p = self.freq * p + (1 - self.freq) / self.num_seqs
        return np.log(np.maximum(p, 1e-12)).astype(np.float32)

    def state_dict(self):
        return {"records": self.records, "fail_starts": self.fail_starts}

    def load_state_dict(self, d):
        recs = [list(r) for r in d["records"]]
        # Resume-safe across library-size changes (e.g. warm-starting a
        # larger clip library from a smaller run's checkpoint): keep the
        # overlapping histories, start fresh ones empty.
        if len(recs) < self.num_seqs:
            recs += [[] for _ in range(self.num_seqs - len(recs))]
        self.records = recs[:self.num_seqs]
        # pre-precision_mode checkpoints carry no fail_starts
        fs = [list(r) for r in d.get("fail_starts",
                                     [[] for _ in range(self.num_seqs)])]
        if len(fs) < self.num_seqs:
            fs += [[] for _ in range(self.num_seqs - len(fs))]
        self.fail_starts = fs[:self.num_seqs]
