"""COCO-style bbox evaluator: the COCO container, detection loading,
greedy IoU matching with crowd/ignore rules, PR accumulation and the
12-number summary.

A copy of ``neuralnetworklibrary_tpu/utils/cocoeval.py`` (the reference's
vendored pycocotools, bbox path only, with its Pascal ``ignore``
modification, pycocotools/cocoeval.py:106-119).  The IoU matrix and the
greedy matching run in C++ (``native/cocoeval.cpp``, built with g++ at
first use by ``kernels.build``); a failed build raises.  The numpy
:func:`iou_xywh_numpy` and :func:`match_greedy_numpy` compute the same
and are the plain versions the tests hold the C++ against.
"""

from __future__ import annotations

import copy
import ctypes
import json
from collections import defaultdict

import numpy as np

from neuralnetworklibrary_tpu_torch.kernels import build

_I64, _U8P, _F64P, _I64P = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_int64))
# (argtypes, restype) of every C entry point of native/cocoeval.cpp
SIGNATURES = {
    # dets, gts, iscrowd, D, G, out
    "iou_xywh": ([_F64P, _F64P, _U8P, _I64, _I64, _F64P], None),
    # ious, gt_ig, iscrowd, thrs, D, G, T, dtm, gtm, dt_ig
    "match_greedy": ([_F64P, _U8P, _U8P, _F64P, _I64, _I64, _I64, _I64P,
                      _I64P, _U8P], None),
}


def _f64p(a):
    return a.ctypes.data_as(_F64P)


def _u8p(a):
    return a.ctypes.data_as(_U8P)


def _i64p(a):
    return a.ctypes.data_as(_I64P)


def bbox_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd) -> np.ndarray:
    """IoU between (D, 4) and (G, 4) xywh boxes -> (D, G), by the C++
    helper.  For a crowd gt the denominator is the detection's area alone
    (pycocotools' 'iou')."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    D, G = len(dets), len(gts)
    d = np.ascontiguousarray(dets, np.float64)
    g = np.ascontiguousarray(gts, np.float64)
    c = np.ascontiguousarray(np.asarray(iscrowd), np.uint8)
    out = np.empty((D, G), np.float64)
    build.bind("cocoeval", SIGNATURES).iou_xywh(_f64p(d), _f64p(g), _u8p(c),
                                                D, G, _f64p(out))
    return out


def iou_xywh_numpy(dets: np.ndarray, gts: np.ndarray, iscrowd) -> np.ndarray:
    """:func:`bbox_iou_xywh` in numpy (the plain version)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dets = np.asarray(dets, np.float64)
    gts = np.asarray(gts, np.float64)
    dx, dy, dw, dh = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    gx, gy, gw, gh = gts[:, 0], gts[:, 1], gts[:, 2], gts[:, 3]
    x1 = np.maximum(dx[:, None], gx[None, :])
    y1 = np.maximum(dy[:, None], gy[None, :])
    x2 = np.minimum((dx + dw)[:, None], (gx + gw)[None, :])
    y2 = np.minimum((dy + dh)[:, None], (gy + gh)[None, :])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    da = (dw * dh)[:, None]
    ga = (gw * gh)[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_greedy(ious, gt_ig, iscrowd, thrs):
    """Greedy matching of D score-sorted detections to G ignore-last
    ground truths at each IoU threshold, by the C++ helper.  Returns
    (dtm (T, D), gtm (T, G)) int64 slots + 1 of the match (0: none) and
    dt_ig (T, D) bool: the detection matched an ignored gt."""
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.int64)
    gtm = np.zeros((T, G), np.int64)
    dt_ig = np.zeros((T, D), np.uint8)
    build.bind("cocoeval", SIGNATURES).match_greedy(
        _f64p(np.ascontiguousarray(ious, np.float64)),
        _u8p(np.ascontiguousarray(gt_ig, np.uint8)),
        _u8p(np.ascontiguousarray(np.asarray(iscrowd), np.uint8)),
        _f64p(np.ascontiguousarray(thrs, np.float64)), D, G, T,
        _i64p(dtm), _i64p(gtm), _u8p(dt_ig))
    return dtm, gtm, dt_ig.astype(bool)


def match_greedy_numpy(ious, gt_ig, iscrowd, thrs):
    """:func:`match_greedy` in python (the plain version)."""
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.int64)
    gtm = np.zeros((T, G), np.int64)
    dt_ig = np.zeros((T, D), bool)
    for ti, t in enumerate(thrs):
        for di in range(D):
            best, m = min(t, 1 - 1e-10), -1
            for gi in range(G):
                if gtm[ti, gi] > 0 and not iscrowd[gi]:
                    continue
                # gts are ignore-last: once a real match is held, stop at
                # the first ignored gt
                if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                    break
                if ious[di, gi] < best:
                    continue
                best, m = ious[di, gi], gi
            if m == -1:
                continue
            dtm[ti, di] = m + 1
            gtm[ti, m] = di + 1
            dt_ig[ti, di] = bool(gt_ig[m])
    return dtm, gtm, dt_ig


class COCO:
    """Minimal COCO annotation API (the slice pycocotools/coco.py the
    reference uses): init from a json file/dict, index anns by image and
    category, and loadRes for detection results."""

    def __init__(self, annotation_file=None):
        self.dataset: dict = {}
        self.anns: dict = {}
        self.imgs: dict = {}
        self.cats: dict = {}
        self.imgToAnns = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.createIndex()

    def createIndex(self):
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.imgToAnns[ann["image_id"]].append(ann)
            if "category_id" in ann:
                self.catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def info(self):
        """Print the dataset's info block (coco.py:102-107)."""
        for k, v in self.dataset.get("info", {}).items():
            print(f"{k}: {v}")

    @staticmethod
    def _as_list(x):
        return x if isinstance(x, (list, tuple)) else [x]

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        """Annotation ids matching every given filter (coco.py:109-136):
        image membership, category, area range [lo, hi), and the iscrowd
        flag (None = both)."""
        imgIds, catIds = self._as_list(imgIds), self._as_list(catIds)
        areaRng = list(areaRng)
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cset = set(catIds)
            anns = [a for a in anns if a.get("category_id") in cset]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a.get("area", 0) < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        """Category ids filtered by name / supercategory / id (coco.py:138-161)."""
        catNms, supNms, catIds = map(self._as_list, (catNms, supNms, catIds))
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c.get("name") in set(catNms)]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in set(supNms)]
        if catIds:
            cats = [c for c in cats if c["id"] in set(catIds)]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=(), catIds=()):
        """Image ids: intersection of the given ids (or all) with images
        containing ALL the given categories (coco.py:163-183)."""
        imgIds, catIds = self._as_list(imgIds), self._as_list(catIds)
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for c in catIds:
            ids &= set(self.catToImgs[c])
        return list(ids)

    def loadAnns(self, ids=()):
        return [self.anns[i] for i in self._as_list(ids)]

    def loadCats(self, ids=()):
        return [self.cats[i] for i in self._as_list(ids)]

    def loadImgs(self, ids=()):
        return [self.imgs[i] for i in self._as_list(ids)]

    def showAnns(self, anns):
        """Draw bbox annotations on the current matplotlib axes
        (coco.py:185-233, bbox path; this library has no mask support —
        Vision.py:19-20)."""
        if not anns:
            return
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        ax = plt.gca()
        rng = np.random.default_rng(0)
        for ann in anns:
            if "bbox" not in ann:
                continue
            x, y, w, h = ann["bbox"]
            color = rng.uniform(0.2, 1.0, 3)
            ax.add_patch(Rectangle((x, y), w, h, fill=False,
                                   edgecolor=color, linewidth=2))

    def loadRes(self, resFile) -> "COCO":
        """Detection results (json path or list of dicts with image_id,
        category_id, bbox xywh, score) → a result COCO object."""
        res = COCO()
        res.dataset["images"] = list(self.dataset.get("images", []))
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(list(resFile))
        for i, ann in enumerate(anns):
            bb = ann["bbox"]
            ann.setdefault("area", bb[2] * bb[3])
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res


class Params:
    """Default bbox evaluation parameters (pycocotools/cocoeval.py:506-533)."""

    def __init__(self):
        self.imgIds: list = []
        self.catIds: list = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1


class COCOeval:
    """bbox COCOeval with the reference's Pascal-'ignore' modification
    (pycocotools/cocoeval.py:10-533; ignore handling :106-119)."""

    def __init__(self, cocoGt: COCO, cocoDt: COCO, iouType: str = "bbox"):
        if iouType != "bbox":
            raise NotImplementedError("only iouType='bbox' is supported")
        self.cocoGt, self.cocoDt = cocoGt, cocoDt
        self.params = Params()
        self.params.imgIds = sorted(cocoGt.getImgIds())
        self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs: dict = {}
        self.eval: dict = {}
        self.stats = np.zeros(12)

    # ------------------------------------------------------------- evaluate

    def _gather(self, coco: COCO, imgId, catId):
        return [a for a in coco.imgToAnns[imgId] if a["category_id"] == catId]

    def evaluate(self):
        """Per (image, category, areaRng) greedy matching — like pycocotools,
        each area range runs its OWN matching pass with out-of-range gts
        treated as ignored (they neither demand recall nor penalize matched
        detections)."""
        p = self.params
        maxDet = p.maxDets[-1]
        for imgId in p.imgIds:
            for catId in p.catIds:
                for a, aRng in enumerate(p.areaRng):
                    self.evalImgs[imgId, catId, a] = self._evaluate_img(
                        imgId, catId, aRng, maxDet)

    def _evaluate_img(self, imgId, catId, aRng, maxDet):
        p = self.params
        gts = self._gather(self.cocoGt, imgId, catId)
        dts = self._gather(self.cocoDt, imgId, catId)
        if len(gts) == 0 and len(dts) == 0:
            return None

        # the reference's modification: an explicit 'ignore' flag wins; else
        # iscrowd implies ignore (cocoeval.py:106-119); a gt outside this
        # area range is also ignored (cocoeval.py:111)
        for g in gts:
            base = int(g["ignore"]) if "ignore" in g else int(g.get("iscrowd", 0))
            area = g.get("area", g["bbox"][2] * g["bbox"][3])
            g["_ignore"] = int(base or area < aRng[0] or area > aRng[1])

        dts = sorted(dts, key=lambda d: -d["score"])[:maxDet]
        gt_order = np.argsort([g["_ignore"] for g in gts], kind="stable")
        gts = [gts[i] for i in gt_order]

        D, G, T = len(dts), len(gts), len(p.iouThrs)
        dt_boxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(D, 4)
        gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(G, 4)
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        ious = bbox_iou_xywh(dt_boxes, gt_boxes, iscrowd)

        gt_ig = np.asarray([g["_ignore"] for g in gts]) if G else np.zeros(0, int)
        dt_areas = dt_boxes[:, 2] * dt_boxes[:, 3]
        dt_out = (dt_areas < aRng[0]) | (dt_areas > aRng[1])

        # greedy matching per threshold (cocoeval.py:129-228), in C++;
        # a slot + 1 maps to the matched gt's id
        dtm_slots, _, dt_ig = match_greedy(ious, gt_ig, iscrowd, p.iouThrs)
        gt_ids = np.asarray([g["id"] for g in gts], np.int64)
        dtm = (np.where(dtm_slots > 0, gt_ids[np.maximum(dtm_slots - 1, 0)], 0)
               if G else dtm_slots)

        # pycocotools cocoeval.py:225-226: an unmatched det outside the area
        # range is also ignored for this range
        dt_ig = dt_ig | ((dtm == 0) & dt_out[None, :])

        return {
            "dtScores": np.asarray([d["score"] for d in dts]),
            "dtm": dtm,
            "dtIgnore": dt_ig,
            "gtIgnore": gt_ig,
            "num_gt": G,
        }

    # ----------------------------------------------------------- accumulate

    def accumulate(self):
        p = self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, catId in enumerate(p.catIds):
            for a in range(A):
                Es = [self.evalImgs.get((imgId, catId, a)) for imgId in p.imgIds]
                Es = [e for e in Es if e is not None]
                if not Es:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    scores, matched, ignored = [], [], []
                    npig = 0
                    for e in Es:
                        npig += int((~e["gtIgnore"].astype(bool)).sum())
                        d = min(maxDet, len(e["dtScores"]))
                        scores.append(e["dtScores"][:d])
                        matched.append(e["dtm"][:, :d])
                        ignored.append(e["dtIgnore"][:, :d])
                    if npig == 0:
                        continue
                    scores = np.concatenate(scores)
                    matched = np.concatenate(matched, axis=1)
                    ignored = np.concatenate(ignored, axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched, ignored = matched[:, order], ignored[:, order]

                    tps = (matched > 0) & ~ignored
                    fps = (matched == 0) & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[ti, k, a, m] = rc[-1] if nd else 0
                        # precision envelope (monotone decreasing)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, p.recThrs, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, k, a, m] = q

        self.eval = {"precision": precision, "recall": recall,
                     "counts": [T, R, K, A, M], "params": p}

    # ------------------------------------------------------------ summarize

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        # pycocotools filters (cocoeval.py:437-438): an absent maxDets/area
        # label selects an empty slice and reports -1, it does not raise
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(np.isclose(p.iouThrs, iouThr))[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(np.isclose(p.iouThrs, iouThr))[0]]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        mean = float(np.mean(valid)) if valid.size else -1.0
        kind = "Average Precision" if ap else "Average Recall"
        abbr = "AP" if ap else "AR"
        t = (f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}"
             if iouThr is None else f"{iouThr:0.2f}")
        print(f" {kind:<18} ({abbr}) @[ IoU={t:<9} | area={areaRng:>6s} | "
              f"maxDets={maxDets:>3d} ] = {mean:0.3f}")
        return mean

    def summarize(self):
        """The standard 12-metric summary (cocoeval.py:430-504)."""
        s = self.stats = np.zeros(12)
        s[0] = self._summarize(1)
        s[1] = self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2])
        s[2] = self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2])
        s[3] = self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2])
        s[4] = self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2])
        s[5] = self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2])
        s[6] = self._summarize(0, maxDets=self.params.maxDets[0])
        s[7] = self._summarize(0, maxDets=self.params.maxDets[1])
        s[8] = self._summarize(0, maxDets=self.params.maxDets[2])
        s[9] = self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2])
        s[10] = self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2])
        s[11] = self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2])
        return s
