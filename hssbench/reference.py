"""The plain reference: torch's sort of the very keys handed to the port,
and the comparisons that decide `correct`. It imports nothing of the port
and takes nothing the port made: the harness hands it the input arrays and
the answers (keys read off the card by the harness's own code), on the
device the cell ran on."""
from __future__ import annotations

import torch


def valid_keys(shards: torch.Tensor, counts) -> torch.Tensor:
    """The valid prefix of each shard row, in shard order."""
    return torch.cat([shards[i, :int(c)]
                      for i, c in enumerate(counts.tolist())])


def wrong_keys(answer: torch.Tensor, expected: torch.Tensor) -> int:
    """Keys of `answer` that differ from the sorted `expected`, counting
    every missing or extra key as wrong."""
    n = min(answer.shape[0], expected.shape[0])
    return int((answer[:n] != expected[:n]).sum().item()
               + abs(answer.shape[0] - expected.shape[0]))


def imbalance_excess(counts, n: int) -> float:
    """max shard load / (N / p) - 1: what the configuration's eps bounds."""
    counts = torch.as_tensor(counts)
    return float(counts.max().item()) * counts.shape[0] / float(n) - 1.0


class Comparison:
    """The numbers a run compares, each with its limit."""

    def __init__(self):
        self.checked = 0
        self.wrong = 0
        self.worst_excess: float | None = None

    def answer(self, answer: torch.Tensor, keys: torch.Tensor) -> None:
        """Compare one answer with the sort of its input `keys`."""
        self.checked += 1
        self.wrong += wrong_keys(answer, torch.sort(keys).values)

    def balance(self, counts, n: int) -> None:
        e = imbalance_excess(counts, n)
        self.worst_excess = (e if self.worst_excess is None
                             else max(self.worst_excess, e))

    def checks(self, guarantees: dict, failed: int) -> dict:
        """{name: {"value", "limit", "ok"}} of every number compared;
        `failed` calls raised and gave no answer."""
        out = {
            "answers_checked": {"value": self.checked, "limit": 1,
                                "ok": self.checked >= 1},
            "calls_failed": {"value": failed, "limit": 0,
                             "ok": failed == 0},
            "wrong_keys": {"value": self.wrong, "limit": 0,
                           "ok": self.wrong == 0},
        }
        if self.worst_excess is not None:
            eps = float(guarantees["balance_eps"])
            out["imbalance_excess"] = {"value": self.worst_excess,
                                       "limit": eps,
                                       "ok": self.worst_excess <= eps}
        return out
