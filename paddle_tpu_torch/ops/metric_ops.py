"""Metric ops — port of ``paddle_tpu/ops/metric_ops.py`` for ``accuracy``
(:10), ``auc`` (:25), ``precision_recall`` (:69) and ``chunk_eval``
(:124).

``auc``'s histograms are integer scatter-adds, exact on the card in any
order. Its stats stay int64 here, as the desc says; the reference runs
them as int32 (its 64-bit types are off), so its ``tp * fp`` products
overflow past about 46,341 positives or negatives and this port's do
not."""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op
from paddle_tpu_torch.ops.common import single


@register_no_grad_op("accuracy")
def accuracy(ctx, ins, attrs):
    """A row is correct when any of its top-k ``Indices`` [N, k] is its
    ``Label`` [N, 1]: ``Accuracy`` float32 [1], ``Correct`` and ``Total``
    int32 [1]."""
    indices = single(ins, "Indices")
    label = single(ins, "Label").reshape(-1, 1).to(indices.dtype)
    n = indices.shape[0]
    correct = (indices == label).any(dim=1).sum(dtype=torch.int32)
    return {"Accuracy": [(correct.float() / n).reshape(1)],
            "Correct": [correct.reshape(1)],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=indices.device)]}


@register_no_grad_op("auc")
def auc(ctx, ins, attrs):
    """Streaming ROC AUC: each row's positive probability ``Predict[:, 1]``
    falls in one of ``num_thresholds + 1`` buckets, counted into the
    positive or negative histogram ``StatPos`` / ``StatNeg`` by its label;
    ``StatPosOut`` / ``StatNegOut`` are the updated histograms (the same
    persistable vars) and ``AUC`` the trapezoid area under the curve of
    the cumulative counts from the top bucket down, float32 []."""
    predict = single(ins, "Predict")  # [N, 2]
    stat_pos, stat_neg = single(ins, "StatPos"), single(ins, "StatNeg")
    nt = attrs.get("num_thresholds", 4095)
    bucket = torch.clamp((predict[:, 1] * nt).long(), 0, nt)
    lab = single(ins, "Label").reshape(-1).to(stat_pos.dtype)
    new_pos = stat_pos.scatter_add(0, bucket, lab)
    new_neg = stat_neg.scatter_add(0, bucket, 1 - lab)
    tp = torch.cumsum(torch.flip(new_pos, [0]), 0)
    fp = torch.cumsum(torch.flip(new_neg, [0]), 0)
    zero = tp.new_zeros(1)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    value = torch.where(
        (tot_pos > 0) & (tot_neg > 0),
        area / torch.clamp_min((tot_pos * tot_neg).to(area.dtype), 1.0),
        torch.zeros_like(area))
    return {"AUC": [value.to(torch.float32).reshape(())],
            "StatPosOut": [new_pos], "StatNegOut": [new_neg]}


def _pr_metrics(st):
    """[macro P, macro R, macro F1, micro P, micro R, micro F1] of the
    per-class (TP, FP, TN, FN) rows ``st``; an empty denominator gives a
    precision or recall of 1 and an F1 of 0."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]

    def ratio(num, den, empty):
        return torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                           torch.full_like(num, empty))

    p = ratio(tp, tp + fp, 1.0)
    r = ratio(tp, tp + fn, 1.0)
    f1 = ratio(2 * p * r, p + r, 0.0)
    micro_p = ratio(tp.sum(), (tp + fp).sum(), 1.0)
    micro_r = ratio(tp.sum(), (tp + fn).sum(), 1.0)
    micro_f1 = ratio(2 * micro_p * micro_r, micro_p + micro_r, 0.0)
    return torch.stack([p.mean(), r.mean(), f1.mean(), micro_p, micro_r,
                        micro_f1])


@register_no_grad_op("precision_recall")
def precision_recall(ctx, ins, attrs):
    """Per-class precision, recall and F1 of the predicted classes
    ``Indices`` [N, 1] against ``Labels`` [N, 1], optionally weighted:
    ``BatchMetrics`` and ``AccumMetrics`` (with the states ``StatesInfo``
    added) as ``_pr_metrics``, ``AccumStatesInfo`` [C, 4] the (TP, FP, TN,
    FN) sums, float32."""
    pred = single(ins, "Indices").reshape(-1).long()
    lab = single(ins, "Labels").reshape(-1).long()
    weights = single(ins, "Weights")
    states = single(ins, "StatesInfo")
    w = (weights.reshape(-1).float() if weights is not None
         else torch.ones(pred.shape, dtype=torch.float32, device=pred.device))
    cls = torch.arange(int(attrs["class_number"]), device=pred.device)[:, None]
    is_pred, is_lab = pred[None, :] == cls, lab[None, :] == cls
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    tp = torch.where(is_pred & is_lab, w, zero).sum(1)
    fp = torch.where(is_pred & ~is_lab, w, zero).sum(1)
    fn = torch.where(~is_pred & is_lab, w, zero).sum(1)
    tn = w.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = batch + states.float() if states is not None else batch
    return {"BatchMetrics": [_pr_metrics(batch)],
            "AccumMetrics": [_pr_metrics(accum)],
            "AccumStatesInfo": [accum]}


_NUM_TAGS = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _shift(x, fill, forward):
    """``x`` [B, T] moved one step along T (the previous step's value at
    each step when ``forward``, else the next one's), ``fill`` at the
    edge."""
    edge = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    if forward:
        return torch.cat([edge, x[:, :-1]], 1)
    return torch.cat([x[:, 1:], edge], 1)


@register_no_grad_op("chunk_eval")
def chunk_eval(ctx, ins, attrs):
    """Chunk-level precision, recall and F1 of the tags ``Inference``
    against ``Label`` [B, T] under the ``plain``, IOB, IOE or IOBES
    scheme (a label is chunk_type * num_tag_types + tag; labels from
    num_chunk_types * num_tag_types up are outside any chunk), over the
    first ``SeqLength`` steps of each row. A chunk is its (begin, end,
    type) and is correct when the label has the same one (conlleval's
    rule); ``excluded_chunk_types`` count nowhere."""
    inf, lab = single(ins, "Inference"), single(ins, "Label")
    if inf.ndim == 3 and inf.shape[-1] == 1:
        inf = inf[..., 0]
    if lab.ndim == 3 and lab.shape[-1] == 1:
        lab = lab[..., 0]
    inf, lab = inf.long(), lab.long()
    B, T = lab.shape
    scheme = attrs.get("chunk_scheme", "IOB")
    num_tag = _NUM_TAGS[scheme]
    out_start = int(attrs["num_chunk_types"]) * num_tag
    excluded = set(attrs.get("excluded_chunk_types", []) or [])
    lens = single(ins, "SeqLength")
    lens = (lens.reshape(-1).long() if lens is not None
            else torch.full((B,), T, dtype=torch.int64, device=lab.device))
    steps = torch.arange(T, device=lab.device)
    valid = steps[None, :] < lens[:, None]

    def marks(x):
        inside = (x < out_start) & valid
        ctype = torch.div(x, num_tag, rounding_mode="floor")
        tag = torch.remainder(x, num_tag)
        prev_tag, next_tag = _shift(tag, -1, True), _shift(tag, -1, False)
        # a run of the same type continues from the previous step / into
        # the next
        cont = _shift(inside, False, True) & (_shift(ctype, -1, True) == ctype)
        cont_n = (_shift(inside, False, False)
                  & (_shift(ctype, -1, False) == ctype))
        if scheme == "plain":    # every in-chunk token its own chunk
            start = end = inside
        elif scheme == "IOB":    # B=0, I=1
            start = inside & ((tag == 0) | ~cont)
            end = inside & (~cont_n | (next_tag == 0))
        elif scheme == "IOE":    # I=0, E=1
            start = inside & (~cont | (prev_tag == 1))
            end = inside & ((tag == 1) | ~cont_n)
        else:                    # IOBES: B=0 I=1 E=2 S=3
            start = inside & ((tag == 0) | (tag == 3) | ~cont
                              | (prev_tag == 2) | (prev_tag == 3))
            end = inside & ((tag == 2) | (tag == 3) | ~cont_n
                            | (next_tag == 0) | (next_tag == 3))
        for e in excluded:
            start, end = start & (ctype != e), end & (ctype != e)
        return start, end, ctype

    def end_index(end):
        # at each step, the first chunk end at or after it (T for none)
        idx = torch.where(end, steps[None, :], torch.full_like(end, T,
                                                               dtype=torch.int64))
        return torch.flip(torch.cummin(torch.flip(idx, [1]), 1).values, [1])

    s_inf, e_inf, ct_inf = marks(inf)
    s_lab, e_lab, ct_lab = marks(lab)
    match = (s_inf & s_lab & (ct_inf == ct_lab)
             & (end_index(e_inf) == end_index(e_lab)))
    n_inf, n_lab, n_cor = s_inf.sum(), s_lab.sum(), match.sum()
    zero = torch.zeros((), dtype=torch.float32, device=lab.device)
    p = torch.where(n_inf > 0, n_cor / torch.clamp_min(n_inf, 1), zero)
    r = torch.where(n_lab > 0, n_cor / torch.clamp_min(n_lab, 1), zero)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.clamp_min(p + r, 1e-12),
                     zero)
    return {"Precision": [p.reshape(1)], "Recall": [r.reshape(1)],
            "F1-Score": [f1.reshape(1)],
            "NumInferChunks": [n_inf.reshape(1)],
            "NumLabelChunks": [n_lab.reshape(1)],
            "NumCorrectChunks": [n_cor.reshape(1)]}
