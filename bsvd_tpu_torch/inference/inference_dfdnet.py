"""DFDNet face restoration (counterpart of the JAX repo's
inference/inference_dfdnet.py; the same flags and the same
``results/DFDNet/<test folder>/`` layout).

    python -m bsvd_tpu_torch.inference.inference_dfdnet \\
        --test_path datasets/TestWhole [--upscale_factor 2] \\
        [--model_path <DFDNet .pth>] [--dict_path <dictionary .pth>] \\
        [--device cuda|cpu]

dlib face detection -> 5-landmark alignment to the FFHQ template ->
DFDNet on each 512 x 512 crop, guided by 68-landmark part boxes ->
soft-mask paste-back, the image work on ``--device``. It needs the
DFDNet weights, the component dictionary and dlib's models (none in the
repository). Without dlib it stops where the JAX script stops: ImportError
from ``FaceRestorationHelper.init_dlib``.
"""

import argparse
import glob
import os

import numpy as np
import torch


def get_part_location(landmarks):
    """68 landmarks -> the boxes of the left eye, right eye, nose and
    mouth, each (1, 4) [x0, y0, x1, y1]."""
    maps = {
        'left_eye': list(np.hstack((range(17, 22), range(36, 42)))),
        'right_eye': list(np.hstack((range(22, 27), range(42, 48)))),
        'nose': list(range(29, 36)),
        'mouth': list(range(48, 68)),
    }
    locations = []
    for part in ('left_eye', 'right_eye', 'nose', 'mouth'):
        pts = landmarks[maps[part]]
        mean = np.mean(pts, 0)
        half_len = np.max((np.max(np.max(pts, 0) - np.min(pts, 0)) / 2, 16))
        loc = np.hstack((mean - half_len + 1, mean + half_len)).astype(int)
        locations.append(loc[None])
    return tuple(locations)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--upscale_factor', type=int, default=2)
    parser.add_argument(
        '--model_path', type=str,
        default='experiments/pretrained_models/DFDNet/'
                'DFDNet_official-d1fa5650.pth')
    parser.add_argument(
        '--dict_path', type=str,
        default='experiments/pretrained_models/DFDNet/'
                'DFDNet_dict_512-f79685f0.pth')
    parser.add_argument('--test_path', type=str, default='datasets/TestWhole')
    parser.add_argument('--upsample_num_times', type=int, default=1)
    parser.add_argument('--save_inverse_affine', action='store_true')
    parser.add_argument('--only_keep_largest', action='store_true')
    parser.add_argument(
        '--detection_path', type=str,
        default='experiments/pretrained_models/dlib/'
                'mmod_human_face_detector-4cb19393.dat')
    parser.add_argument(
        '--landmark5_path', type=str,
        default='experiments/pretrained_models/dlib/'
                'shape_predictor_5_face_landmarks-c4b1e980.dat')
    parser.add_argument(
        '--landmark68_path', type=str,
        default='experiments/pretrained_models/dlib/'
                'shape_predictor_68_face_landmarks-fbdc2cb8.dat')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from bsvd_tpu_torch.archs.dfdnet_arch import DFDNet
    from bsvd_tpu_torch.utils.face_util import FaceRestorationHelper
    from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img

    if args.test_path.endswith('/'):
        args.test_path = args.test_path[:-1]
    result_root = f'results/DFDNet/{os.path.basename(args.test_path)}'

    net = DFDNet(64, dict_path=args.dict_path,
                 pretrain_path=args.model_path).to(args.device)

    save_crop_root = os.path.join(result_root, 'cropped_faces')
    save_inverse_affine_root = os.path.join(result_root, 'inverse_affine')
    os.makedirs(save_inverse_affine_root, exist_ok=True)
    save_restore_root = os.path.join(result_root, 'restored_faces')
    save_final_root = os.path.join(result_root, 'final_results')

    face_helper = FaceRestorationHelper(args.upscale_factor, face_size=512,
                                        device=args.device)

    for img_path in sorted(glob.glob(os.path.join(args.test_path,
                                                  '*.[jp][pn]g'))):
        img_name = os.path.basename(img_path)
        print(f'Processing {img_name} image ...')
        save_crop_path = os.path.join(save_crop_root, img_name)
        save_inverse_affine_path = (
            os.path.join(save_inverse_affine_root, img_name)
            if args.save_inverse_affine else None)

        face_helper.init_dlib(args.detection_path, args.landmark5_path,
                              args.landmark68_path)
        num_det_faces = face_helper.detect_faces(
            img_path, upsample_num_times=args.upsample_num_times,
            only_keep_largest=args.only_keep_largest)
        num_landmarks = face_helper.get_face_landmarks_5()
        print(f'\tDetect {num_det_faces} faces, {num_landmarks} landmarks.')
        face_helper.warp_crop_faces(save_crop_path, save_inverse_affine_path)

        num_landmarks = face_helper.get_face_landmarks_68()
        print(f'\tDetect {num_landmarks} faces for 68 landmarks.')
        face_helper.free_dlib_gpu_memory()

        print('\tFace restoration ...')
        for idx, (cropped_face, landmarks) in enumerate(
                zip(face_helper.cropped_faces, face_helper.all_landmarks_68)):
            if landmarks is None:
                print(f'Landmarks is None, skip cropped faces with idx '
                      f'{idx}.')
                restored_face = cropped_face.flip(-1).cpu().numpy()
            else:
                part_locations = get_part_location(landmarks)
                # RGB uint8 -> (1, 3, 512, 512) in [-1, 1]
                x = (cropped_face.float() / 255. - 0.5) / 0.5
                x = x.permute(2, 0, 1)[None].contiguous()
                try:
                    with torch.no_grad():
                        output = net(x, part_locations)
                    restored_face = tensor2img(output[0].cpu().numpy(),
                                               min_max=(-1, 1))
                except Exception as e:              # noqa: BLE001
                    print(f'DFDNet inference fail: {e}')
                    restored_face = tensor2img(x[0].cpu().numpy(),
                                               min_max=(-1, 1))
            path = os.path.splitext(
                os.path.join(save_restore_root, img_name))[0]
            imwrite(restored_face, f'{path}_{idx:02d}.png')
            face_helper.add_restored_face(restored_face)

        print('\tGenerate the final result ...')
        face_helper.paste_faces_to_input_image(
            os.path.join(save_final_root, img_name))
        face_helper.clean_all()

    print(f'\nAll results are saved in {result_root}')


if __name__ == '__main__':
    main()
