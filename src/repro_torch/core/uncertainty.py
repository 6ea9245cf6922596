"""Uncertainty metrics and decision rules (paper Eq. 1, Eq. 2, Figs. 4-5).

PyTorch counterpart of ``repro.core.uncertainty``.  Given N Monte-Carlo
predictive distributions p_n(c) (softmax outputs of N sampled forward
passes):

  total      H  = entropy( mean_n p_n )                      (Eq. 1)
  aleatoric  SE = mean_n entropy( p_n )                      (Eq. 2)
  epistemic  MI = H - SE                                     (mutual info)

Decision rules:
  * OOD rejection: reject if MI > threshold  (epistemic flag, Fig. 4c/d)
  * ambiguity flag: SE high, MI low          (aleatoric, Fig. 5e)

Also: threshold-sweep ROC / AUROC and rejection-accuracy curves used for
the paper's headline numbers.
"""

from __future__ import annotations

import torch

_EPSLOG = 1e-12


def _entropy(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return -torch.sum(p * torch.log(p + _EPSLOG), dim=dim)


def predictive_moments(probs: torch.Tensor) -> dict[str, torch.Tensor]:
    """probs: (N, ..., C) MC samples of class probabilities.

    Returns dict of (...,)-shaped H, SE, MI and (..., C) mean predictive.
    """
    p_mean = probs.mean(dim=0)
    h = _entropy(p_mean)
    se = _entropy(probs).mean(dim=0)
    mi = torch.clamp(h - se, min=0.0)
    return {"p_mean": p_mean, "H": h, "SE": se, "MI": mi}


def uncertainty_from_logits(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """logits: (N, ..., C) MC samples -> same dict as predictive_moments,
    with the softmax taken in float32 through a log-softmax."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    p_mean = probs.mean(dim=0)
    h = _entropy(p_mean)
    se = (-torch.sum(probs * logp, dim=-1)).mean(dim=0)
    mi = torch.clamp(h - se, min=0.0)
    return {"p_mean": p_mean, "H": h, "SE": se, "MI": mi}


# --------------------------------------------------------------------------
# decision rules + evaluation curves
# --------------------------------------------------------------------------

def roc_curve(scores_pos: torch.Tensor, scores_neg: torch.Tensor,
              num_thresholds: int = 512) -> dict[str, torch.Tensor]:
    """ROC of 'score > t => positive' over a threshold sweep.

    scores_pos: scores of true positives (e.g. MI of OOD images),
    scores_neg: scores of true negatives (MI of ID images).
    """
    lo = torch.minimum(scores_pos.min(), scores_neg.min())
    hi = torch.maximum(scores_pos.max(), scores_neg.max())
    ts = torch.linspace(float(hi), float(lo), num_thresholds,
                        device=scores_pos.device)
    tpr = (scores_pos[None, :] > ts[:, None]).float().mean(dim=1)
    fpr = (scores_neg[None, :] > ts[:, None]).float().mean(dim=1)
    return {"thresholds": ts, "tpr": tpr, "fpr": fpr}


def auroc(scores_pos: torch.Tensor, scores_neg: torch.Tensor) -> torch.Tensor:
    """Exact AUROC via the Mann-Whitney U statistic (ties count 1/2)."""
    pos = scores_pos[:, None]
    neg = scores_neg[None, :]
    return (pos > neg).float().mean() + 0.5 * (pos == neg).float().mean()


def rejection_accuracy(p_mean: torch.Tensor, mi: torch.Tensor,
                       labels: torch.Tensor,
                       threshold: float) -> dict[str, torch.Tensor]:
    """Accuracy on accepted (MI <= threshold) samples + rejection rate
    (Fig. 4d / Fig. 5f: rejecting uncertain cases raises ID accuracy)."""
    pred = p_mean.argmax(dim=-1)
    accept = mi <= threshold
    hit = pred == labels
    n_acc = torch.clamp(accept.sum(), min=1)
    return {"accuracy_all": hit.float().mean(),
            "accuracy_accepted": (hit & accept).sum() / n_acc,
            "rejection_rate": 1.0 - accept.float().mean()}


def best_rejection_threshold(mi_id: torch.Tensor, p_mean_id: torch.Tensor,
                             labels_id: torch.Tensor,
                             num_thresholds: int = 256) -> tuple[float, float]:
    """Sweep MI thresholds, return (best_threshold, best_accepted_accuracy)."""
    ts = torch.linspace(float(mi_id.min()), float(mi_id.max()),
                        num_thresholds, device=mi_id.device)

    def acc_at(t):
        r = rejection_accuracy(p_mean_id, mi_id, labels_id, t)
        # mild pressure against rejecting everything
        return r["accuracy_accepted"] - 0.01 * r["rejection_rate"]

    accs = torch.stack([acc_at(t) for t in ts])
    i = int(torch.argmax(accs))
    r = rejection_accuracy(p_mean_id, mi_id, labels_id, ts[i])
    return float(ts[i]), float(r["accuracy_accepted"])


def disentangle_clusters(mi: torch.Tensor, se: torch.Tensor,
                         dataset_id: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-dataset (ID=0, ambiguous=1, OOD=2) centroids in (SE, MI) space
    and their smallest pairwise distance (Fig. 5e's three clusters)."""
    cents = []
    for d in range(3):
        m = (dataset_id == d).float()
        w = m / torch.clamp(m.sum(), min=1)
        cents.append(torch.stack([torch.sum(se * w), torch.sum(mi * w)]))
    c = torch.stack(cents)  # (3, 2)
    d01 = torch.linalg.norm(c[0] - c[1])
    d02 = torch.linalg.norm(c[0] - c[2])
    d12 = torch.linalg.norm(c[1] - c[2])
    return {"centroids": c,
            "min_pairwise": torch.minimum(d01, torch.minimum(d02, d12))}
