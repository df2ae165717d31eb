"""Face-restoration helper (counterpart of ``glare_tpu/sr/utils/face_util.py``;
reference: basicsr/utils/face_util.py:15-192). Host numpy / cv2.

Detect faces with dlib, align them to the FFHQ 5-landmark template by a
similarity transform, restore the crops, and paste them back under an eroded,
blurred soft mask. The detection and landmark stages need ``dlib``; without it
``init_dlib`` raises the JAX module's ImportError. The geometric stages
(``estimate_similarity``, the Umeyama closed form; ``warp_crop_faces``;
``add_restored_face``; ``paste_faces_to_input_image``) need numpy and cv2 only.
Inverse affines are saved as ``.npy``, as the JAX module saves them. ``cv2`` and
``dlib`` are imported where they are used.
"""

from __future__ import annotations

import os

import numpy as np


def _imwrite(img, path):
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, img)


# FFHQ 1024x1024 standard 5 landmarks (reference: face_util.py:23-27):
# right eye, left eye outer/inner pairs and mouth center ordering as dlib's
# shape_predictor_5 emits them.
FFHQ_TEMPLATE_1024 = np.array(
    [
        [686.77227723, 488.62376238],
        [586.77227723, 493.59405941],
        [337.91089109, 488.38613861],
        [437.95049505, 493.51485149],
        [513.58415842, 678.5049505],
    ]
)


def estimate_similarity(src, dst):
    """2-D similarity transform (scale+rotation+translation) mapping src->dst,
    least squares — the skimage ``SimilarityTransform.estimate`` the reference
    uses (face_util.py:28-29), implemented via the Umeyama closed form so the
    helper has no skimage hard-dependency."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones(d)
    if np.linalg.det(cov) < 0:
        sign[-1] = -1
    r = u @ np.diag(sign) @ vt
    var_src = (src_c ** 2).sum() / n
    scale = (s * sign).sum() / var_src if var_src > 0 else 1.0
    t = dst_mean - scale * r @ src_mean
    m = np.eye(3)
    m[:2, :2] = scale * r
    m[:2, 2] = t
    return m


class FaceRestorationHelper:
    """Reference: face_util.py:15-192 (FaceRestorationHelper)."""

    def __init__(self, upscale_factor, face_size=512):
        self.upscale_factor = upscale_factor
        self.face_size = (face_size, face_size)
        self.face_template = FFHQ_TEMPLATE_1024 / (1024 // face_size)

        self.all_landmarks_5 = []
        self.all_landmarks_68 = []
        self.affine_matrices = []
        self.inverse_affine_matrices = []
        self.cropped_faces = []
        self.restored_faces = []
        self.save_png = True
        self.det_faces = []

    # -- dlib-gated detection stages (reference: face_util.py:38-118) ------

    def init_dlib(self, detection_path, landmark5_path, landmark68_path):
        try:
            import dlib
        except ImportError as e:
            raise ImportError(
                "Please install dlib before testing face restoration. "
                "Reference: https://github.com/davisking/dlib"
            ) from e
        self.face_detector = dlib.cnn_face_detection_model_v1(detection_path)
        self.shape_predictor_5 = dlib.shape_predictor(landmark5_path)
        self.shape_predictor_68 = dlib.shape_predictor(landmark68_path)

    def free_dlib_gpu_memory(self):
        del self.face_detector
        del self.shape_predictor_5
        del self.shape_predictor_68

    def read_input_image(self, img_path):
        # RGB HWC uint8, like dlib.load_rgb_image
        import cv2

        self.input_img = cv2.imread(img_path)[:, :, ::-1].copy()

    def detect_faces(self, img_path, upsample_num_times=1, only_keep_largest=False):
        self.read_input_image(img_path)
        det_faces = self.face_detector(self.input_img, upsample_num_times)
        if len(det_faces) == 0:
            print("No face detected. Try to increase upsample_num_times.")
        elif only_keep_largest:
            areas = [
                (f.rect.right() - f.rect.left()) * (f.rect.bottom() - f.rect.top())
                for f in det_faces
            ]
            self.det_faces = [det_faces[int(np.argmax(areas))]]
        else:
            self.det_faces = det_faces
        return len(self.det_faces)

    def get_face_landmarks_5(self):
        for face in self.det_faces:
            shape = self.shape_predictor_5(self.input_img, face.rect)
            self.all_landmarks_5.append(
                np.array([[p.x, p.y] for p in shape.parts()])
            )
        return len(self.all_landmarks_5)

    def get_face_landmarks_68(self):
        num_detected_face = 0
        for idx, face in enumerate(self.cropped_faces):
            det_face = self.face_detector(face, 1)
            if len(det_face) == 0:
                print(f"Cannot find faces in cropped image with index {idx}.")
                self.all_landmarks_68.append(None)
                continue
            areas = [
                (f.rect.right() - f.rect.left()) * (f.rect.bottom() - f.rect.top())
                for f in det_face
            ]
            face_rect = det_face[int(np.argmax(areas))].rect
            shape = self.shape_predictor_68(face, face_rect)
            self.all_landmarks_68.append(np.array([[p.x, p.y] for p in shape.parts()]))
            num_detected_face += 1
        return num_detected_face

    # -- pure-geometry stages (no dlib; reference: face_util.py:120-190) ---

    def warp_crop_faces(self, save_cropped_path=None, save_inverse_affine_path=None):
        """Align each detected face to the template; store forward and
        inverse affines for paste-back."""
        import cv2

        for idx, landmark in enumerate(self.all_landmarks_5):
            affine_matrix = estimate_similarity(landmark, self.face_template)[:2, :]
            self.affine_matrices.append(affine_matrix)
            cropped_face = cv2.warpAffine(self.input_img, affine_matrix, self.face_size)
            self.cropped_faces.append(cropped_face)
            if save_cropped_path is not None:
                path, ext = os.path.splitext(save_cropped_path)
                save_path = f"{path}_{idx:02d}.png" if self.save_png else f"{path}_{idx:02d}{ext}"
                _imwrite(cv2.cvtColor(cropped_face, cv2.COLOR_RGB2BGR), save_path)

            inverse_affine = estimate_similarity(
                self.face_template, np.asarray(landmark) * self.upscale_factor
            )[:2, :]
            self.inverse_affine_matrices.append(inverse_affine)
            if save_inverse_affine_path is not None:
                path, _ = os.path.splitext(save_inverse_affine_path)
                np.save(f"{path}_{idx:02d}.npy", inverse_affine)

    def add_restored_face(self, face):
        self.restored_faces.append(face)

    def paste_faces_to_input_image(self, save_path):
        """Soft-mask composite of restored faces over the upscaled input
        (reference: face_util.py:158-183)."""
        import cv2

        input_img = cv2.cvtColor(self.input_img, cv2.COLOR_RGB2BGR)
        h, w, _ = input_img.shape
        h_up, w_up = h * self.upscale_factor, w * self.upscale_factor
        upsample_img = cv2.resize(input_img, (w_up, h_up)).astype(np.float32)
        assert len(self.restored_faces) == len(self.inverse_affine_matrices), (
            "length of restored_faces and affine_matrices are different."
        )
        for restored_face, inverse_affine in zip(
            self.restored_faces, self.inverse_affine_matrices
        ):
            inv_restored = cv2.warpAffine(restored_face, inverse_affine, (w_up, h_up))
            mask = np.ones((*self.face_size, 3), dtype=np.float32)
            inv_mask = cv2.warpAffine(mask, inverse_affine, (w_up, h_up))
            # remove black borders, then feather the seam proportionally to
            # the pasted face area
            k = 2 * self.upscale_factor
            inv_mask_erosion = cv2.erode(inv_mask, np.ones((k, k), np.uint8))
            inv_restored_remove_border = inv_mask_erosion * inv_restored
            total_face_area = np.sum(inv_mask_erosion) // 3
            w_edge = int(total_face_area**0.5) // 20
            erosion_radius = max(w_edge * 2, 1)
            inv_mask_center = cv2.erode(
                inv_mask_erosion, np.ones((erosion_radius, erosion_radius), np.uint8)
            )
            blur_size = max(w_edge * 2, 0)
            inv_soft_mask = cv2.GaussianBlur(
                inv_mask_center, (blur_size + 1, blur_size + 1), 0
            )
            upsample_img = (
                inv_soft_mask * inv_restored_remove_border
                + (1 - inv_soft_mask) * upsample_img
            )
        if self.save_png:
            save_path = save_path.replace(".jpg", ".png").replace(".jpeg", ".png")
        _imwrite(upsample_img.astype(np.uint8), save_path)

    def clean_all(self):
        self.all_landmarks_5 = []
        self.all_landmarks_68 = []
        self.restored_faces = []
        self.affine_matrices = []
        self.cropped_faces = []
        self.inverse_affine_matrices = []
        self.det_faces = []
