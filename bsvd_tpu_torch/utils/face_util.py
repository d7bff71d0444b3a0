"""Face restoration helper: detect -> align -> restore -> paste back
(counterpart of bsvd_tpu/utils/face_util.py; same methods, same files).

dlib (the detector and the landmark predictors) is optional, guarded as
the JAX package guards it: ``init_dlib`` raises ImportError without it.
Everything else runs without dlib: the similarity fit
(``umeyama_similarity``, float64 numpy on five points, as in JAX), and
the crop, inverse warp, erosion, feathering and blend, which are
``utils/cv2_ops`` on torch tensors on ``device`` (the card unless the
caller passes the CPU). Frames are read and written with the port's own
codecs (``utils/img_util``).

The helper keeps ``input_img`` and ``cropped_faces`` as uint8 RGB tensors
on ``device`` (numpy arrays in JAX); ``add_restored_face`` takes a BGR
uint8 array or tensor; ``paste_faces_to_input_image`` returns the float32
BGR tensor it wrote.
"""

import os

import numpy as np
import torch

from bsvd_tpu_torch.utils import cv2_ops
from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite

try:
    import dlib
except ImportError:
    dlib = None


def umeyama_similarity(src, dst):
    """Least-squares similarity transform (rotation + uniform scale +
    translation) mapping src -> dst; a (2, 3) float64 affine matrix
    (closed-form Umeyama, as JAX's)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones(d)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sign[-1] = -1
    rot = u @ np.diag(sign) @ vt
    var_src = (src_c ** 2).sum() / n
    scale = (s * sign).sum() / var_src
    t = dst_mean - scale * rot @ src_mean
    m = np.zeros((2, 3))
    m[:, :2] = scale * rot
    m[:, 2] = t
    return m


def _host(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class FaceRestorationHelper:
    """The face restoration pipeline's helper (JAX's methods and file
    layout), its image work on ``device``."""

    def __init__(self, upscale_factor, face_size=512, device='cuda'):
        self.upscale_factor = upscale_factor
        self.face_size = (face_size, face_size)
        self.device = torch.device(device)
        # the standard 5 landmarks of FFHQ faces at 1024 x 1024
        self.face_template = np.array(
            [[686.77227723, 488.62376238], [586.77227723, 493.59405941],
             [337.91089109, 488.38613861], [437.95049505, 493.51485149],
             [513.58415842, 678.5049505]])
        self.face_template = self.face_template / (1024 // face_size)

        self.all_landmarks_5 = []
        self.all_landmarks_68 = []
        self.affine_matrices = []
        self.inverse_affine_matrices = []
        self.cropped_faces = []
        self.restored_faces = []
        self.save_png = True

    # ------------------------------------------------------- dlib-backed
    def init_dlib(self, detection_path, landmark5_path, landmark68_path):
        if dlib is None:
            raise ImportError('Please install dlib before testing face '
                              'restoration (reference face_util.py:9-12)')
        self.face_detector = dlib.cnn_face_detection_model_v1(detection_path)
        self.shape_predictor_5 = dlib.shape_predictor(landmark5_path)
        self.shape_predictor_68 = dlib.shape_predictor(landmark68_path)

    def free_dlib_gpu_memory(self):
        del self.face_detector
        del self.shape_predictor_5
        del self.shape_predictor_68

    def read_input_image(self, img_path):
        """The frame as (h, w, 3) uint8 RGB on ``device`` (what
        dlib.load_rgb_image gives), read as cv2.imread's colour mode."""
        with open(img_path, 'rb') as f:
            bgr = imfrombytes(f.read(), 'color')
        self.input_img = cv2_ops.cvt_color(
            torch.from_numpy(bgr).to(self.device), cv2_ops.COLOR_BGR2RGB)

    def detect_faces(self, img_path, upsample_num_times=1,
                     only_keep_largest=False):
        self.read_input_image(img_path)
        det_faces = self.face_detector(_host(self.input_img),
                                       upsample_num_times)
        if len(det_faces) == 0:
            print('No face detected. Try to increase upsample_num_times.')
        elif only_keep_largest:
            print('Detect several faces and only keep the largest.')
            areas = [(f.rect.right() - f.rect.left())
                     * (f.rect.bottom() - f.rect.top()) for f in det_faces]
            self.det_faces = [det_faces[int(np.argmax(areas))]]
        else:
            self.det_faces = det_faces
        return len(self.det_faces)

    def get_face_landmarks_5(self):
        img = _host(self.input_img)
        for face in self.det_faces:
            shape = self.shape_predictor_5(img, face.rect)
            self.all_landmarks_5.append(
                np.array([[part.x, part.y] for part in shape.parts()]))
        return len(self.all_landmarks_5)

    def get_face_landmarks_68(self):
        """68 landmarks for each cropped face (one face expected)."""
        num_detected_face = 0
        for idx, face in enumerate(self.cropped_faces):
            face = _host(face)
            det_face = self.face_detector(face, 1)
            if len(det_face) == 0:
                print(f'Cannot find faces in cropped image with index {idx}.')
                self.all_landmarks_68.append(None)
                continue
            if len(det_face) > 1:
                print('Detect several faces in the cropped face. Use the '
                      'largest one.')
                areas = [(f.rect.right() - f.rect.left())
                         * (f.rect.bottom() - f.rect.top())
                         for f in det_face]
                face_rect = det_face[int(np.argmax(areas))].rect
            else:
                face_rect = det_face[0].rect
            shape = self.shape_predictor_68(face, face_rect)
            self.all_landmarks_68.append(
                np.array([[part.x, part.y] for part in shape.parts()]))
            num_detected_face += 1
        return num_detected_face

    # ------------------------------------------------------ on the device
    def warp_crop_faces(self, save_cropped_path=None,
                        save_inverse_affine_path=None):
        """Affine-align each face to the template; keep the inverse
        transform for the paste-back."""
        for idx, landmark in enumerate(self.all_landmarks_5):
            affine_matrix = umeyama_similarity(landmark, self.face_template)
            self.affine_matrices.append(affine_matrix)
            cropped_face = cv2_ops.warp_affine(self.input_img, affine_matrix,
                                               self.face_size)
            self.cropped_faces.append(cropped_face)
            if save_cropped_path is not None:
                path, ext = os.path.splitext(save_cropped_path)
                suffix = '.png' if self.save_png else ext
                imwrite(_host(cv2_ops.cvt_color(cropped_face,
                                                cv2_ops.COLOR_RGB2BGR)),
                        f'{path}_{idx:02d}{suffix}')

            inverse_affine = umeyama_similarity(
                self.face_template, landmark * self.upscale_factor)
            self.inverse_affine_matrices.append(inverse_affine)
            if save_inverse_affine_path is not None:
                path, _ = os.path.splitext(save_inverse_affine_path)
                np.save(f'{path}_{idx:02d}.npy', inverse_affine)

    def add_restored_face(self, face):
        """A restored face: (face_size, face_size, 3) uint8 BGR, an array
        or a tensor."""
        if not torch.is_tensor(face):
            face = torch.from_numpy(np.ascontiguousarray(face))
        self.restored_faces.append(face.to(self.device))

    def paste_faces_to_input_image(self, save_path):
        """Inverse-warp each restored face and blend it in with an eroded,
        Gaussian-feathered mask; writes and returns the float32 BGR
        result."""
        input_img = cv2_ops.cvt_color(self.input_img, cv2_ops.COLOR_RGB2BGR)
        h, w, _ = input_img.shape
        h_up, w_up = h * self.upscale_factor, w * self.upscale_factor
        upsample_img = cv2_ops.resize(input_img, (w_up, h_up)).float()
        assert len(self.restored_faces) == len(self.inverse_affine_matrices), \
            'length of restored_faces and affine_matrices are different.'
        mask = torch.ones((*self.face_size, 3), dtype=torch.float32,
                          device=self.device)
        for restored_face, inverse_affine in zip(self.restored_faces,
                                                 self.inverse_affine_matrices):
            inv_restored = cv2_ops.warp_affine(restored_face, inverse_affine,
                                               (w_up, h_up))
            inv_mask = cv2_ops.warp_affine(mask, inverse_affine, (w_up, h_up))
            # remove the black border the warp brings in
            inv_mask_erosion = cv2_ops.erode(
                inv_mask, np.ones((2 * self.upscale_factor,
                                   2 * self.upscale_factor), np.uint8))
            inv_restored_remove_border = inv_mask_erosion * inv_restored
            total_face_area = float(inv_mask_erosion.double().sum()) // 3
            # the fusion edge's width follows the face's area
            w_edge = int(total_face_area ** 0.5) // 20
            erosion_radius = w_edge * 2
            inv_mask_center = cv2_ops.erode(
                inv_mask_erosion,
                np.ones((erosion_radius, erosion_radius), np.uint8))
            blur_size = w_edge * 2
            inv_soft_mask = cv2_ops.gaussian_blur(
                inv_mask_center, (blur_size + 1, blur_size + 1), 0)
            upsample_img = (inv_soft_mask * inv_restored_remove_border
                            + (1 - inv_soft_mask) * upsample_img)
        if self.save_png:
            save_path = save_path.replace('.jpg', '.png').replace(
                '.jpeg', '.png')
        imwrite(_host(upsample_img.to(torch.uint8)), save_path)
        return upsample_img

    def clean_all(self):
        self.all_landmarks_5 = []
        self.all_landmarks_68 = []
        self.restored_faces = []
        self.affine_matrices = []
        self.cropped_faces = []
        self.inverse_affine_matrices = []
