// COCO evaluation helpers: the bbox IoU matrix and the greedy
// detection-to-ground-truth matching, behind a plain C interface for ctypes.
//
// A copy of the JAX package's native/cocoeval.cpp.  The reference's COCO
// evaluator computes IoU in the pycocotools `_mask` C extension
// (pycocotools/mask.py:5; only the bbox path is used, Vision.py:2173).
// These are the evaluator's two hot loops: the (D x G) IoU matrix and the
// per-threshold greedy matching sweep (pycocotools/cocoeval.py:129-228,
// crowd re-matching and the ignore-last early break included).
// utils/cocoeval.py loads the library that native/build.py builds; its
// numpy functions of the same names are the plain versions the tests hold
// these against.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o native_cocoeval.so cocoeval.cpp

#include <cstdint>
#include <cmath>

extern "C" {

// IoU between D xywh detections and G xywh ground truths.
// For crowd gts the denominator is the detection area alone.
// dets: D*4, gts: G*4, iscrowd: G, out: D*G (row-major).
void iou_xywh(const double* dets, const double* gts, const uint8_t* iscrowd,
              int64_t D, int64_t G, double* out) {
    for (int64_t d = 0; d < D; ++d) {
        const double dx = dets[d * 4 + 0], dy = dets[d * 4 + 1];
        const double dw = dets[d * 4 + 2], dh = dets[d * 4 + 3];
        const double darea = dw * dh;
        for (int64_t g = 0; g < G; ++g) {
            const double gx = gts[g * 4 + 0], gy = gts[g * 4 + 1];
            const double gw = gts[g * 4 + 2], gh = gts[g * 4 + 3];
            const double iw = std::fmin(dx + dw, gx + gw) - std::fmax(dx, gx);
            const double ih = std::fmin(dy + dh, gy + gh) - std::fmax(dy, gy);
            double iou = 0.0;
            if (iw > 0 && ih > 0) {
                const double inter = iw * ih;
                const double uni = iscrowd[g] ? darea : darea + gw * gh - inter;
                if (uni > 0) iou = inter / uni;
            }
            out[d * G + g] = iou;
        }
    }
}

// Greedy matching for all thresholds at once.
// ious:      D*G, detections already sorted by descending score,
//            gts already sorted ignore-last.
// gt_ignore: G   (0/1)
// iscrowd:   G   (0/1)
// thrs:      T   IoU thresholds
// Outputs (caller-allocated, zero-init not required):
// dtm:   T*D  matched gt slot + 1, or 0 if unmatched
// gtm:   T*G  matched det slot + 1, or 0
// dtig:  T*D  1 if the det matched an ignored gt
void match_greedy(const double* ious, const uint8_t* gt_ignore,
                  const uint8_t* iscrowd, const double* thrs,
                  int64_t D, int64_t G, int64_t T,
                  int64_t* dtm, int64_t* gtm, uint8_t* dtig) {
    for (int64_t t = 0; t < T; ++t) {
        int64_t* dtm_t = dtm + t * D;
        int64_t* gtm_t = gtm + t * G;
        uint8_t* dtig_t = dtig + t * D;
        for (int64_t g = 0; g < G; ++g) gtm_t[g] = 0;
        for (int64_t d = 0; d < D; ++d) {
            double best = thrs[t] < 1.0 - 1e-10 ? thrs[t] : 1.0 - 1e-10;
            int64_t m = -1;
            for (int64_t g = 0; g < G; ++g) {
                // gt already matched (crowds may match repeatedly)
                if (gtm_t[g] > 0 && !iscrowd[g]) continue;
                // gts are sorted ignore-last: once a real match exists,
                // stop at the first ignored gt
                if (m > -1 && gt_ignore[m] == 0 && gt_ignore[g] == 1) break;
                const double v = ious[d * G + g];
                if (v < best) continue;
                best = v;
                m = g;
            }
            if (m == -1) {
                dtm_t[d] = 0;
                dtig_t[d] = 0;
            } else {
                dtm_t[d] = m + 1;
                gtm_t[m] = d + 1;
                dtig_t[d] = gt_ignore[m];
            }
        }
    }
}

}  // extern "C"
