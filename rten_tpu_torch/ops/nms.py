"""NonMaxSuppression (the port of ``rten_tpu/ops/nms.py``; rten
src/ops/non_max_suppression.rs:492).

The output shape [num_selected, 3] depends on the data, so, as in the JAX
package, this runs as a host algorithm on host copies of its inputs (one
device-to-host read of boxes and scores where they are card tensors). The
selected indices come back as a host value.
"""

from __future__ import annotations

import numpy as np

from .registry import get_input, host_value, opt_input, register


def _nms_numpy(boxes, scores, max_out, iou_thresh, score_thresh, center_point_box):
    # boxes [B, N, 4], scores [B, C, N]
    B, C, N = scores.shape
    selected = []
    for b in range(B):
        for c in range(C):
            s = scores[b, c]
            order = np.argsort(-s, kind="stable")
            if score_thresh is not None:
                order = order[s[order] > score_thresh]
            bx = boxes[b]
            if center_point_box:
                cx, cy, w, h = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
                x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
            else:
                y1, x1, y2, x2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
                y1, y2 = np.minimum(y1, y2), np.maximum(y1, y2)
                x1, x2 = np.minimum(x1, x2), np.maximum(x1, x2)
            areas = (x2 - x1) * (y2 - y1)
            keep = []
            for i in order:
                ok = True
                for j in keep:
                    xx1 = max(x1[i], x1[j])
                    yy1 = max(y1[i], y1[j])
                    xx2 = min(x2[i], x2[j])
                    yy2 = min(y2[i], y2[j])
                    inter = max(0.0, xx2 - xx1) * max(0.0, yy2 - yy1)
                    union = areas[i] + areas[j] - inter
                    iou = inter / union if union > 0 else 0.0
                    if iou > iou_thresh:
                        ok = False
                        break
                if ok:
                    keep.append(i)
                    if len(keep) >= max_out:
                        break
            selected.extend((b, c, int(i)) for i in keep)
    return np.asarray(selected, np.int32).reshape(-1, 3)


def _host(x, dtype):
    return np.asarray(host_value(x), dtype)


@register("NonMaxSuppression")
def _nms(ctx, inputs, attrs):
    max_out = opt_input(inputs, 2)
    iou_thresh = opt_input(inputs, 3)
    score_thresh = opt_input(inputs, 4)
    return _nms_numpy(
        _host(get_input(inputs, 0, "boxes"), np.float32),
        _host(get_input(inputs, 1, "scores"), np.float32),
        int(_host(max_out, np.int64).reshape(())) if max_out is not None else 2**31 - 1,
        float(_host(iou_thresh, np.float32).reshape(())) if iou_thresh is not None else 0.0,
        float(_host(score_thresh, np.float32).reshape(())) if score_thresh is not None else None,
        bool(attrs.get("center_point_box", 0)),
    )
