"""Dataset factory (``vit_ed_tpu/data/build.py``): returns
``(dataset, repeat)`` where ``repeat`` multiplies the epoch length, for
every dataset of the JAX factory: ``hisfrag20``, ``div2k``,
``div2k_triplet``, ``pajigsaw``, ``michigan`` and ``geshaem``."""

from __future__ import annotations


def build_dataset(mode, config, transforms):
    name = config.DATA.DATASET
    transform = transforms[mode]
    if name == "hisfrag20":
        from vit_ed_tpu_torch.data.hisfrag import HisFrag20, Split

        dataset = HisFrag20(config.DATA.DATA_PATH, Split.from_string(mode),
                            transform=transform)
        return dataset, 3
    if name == "div2k":
        from vit_ed_tpu_torch.data.div2k import DIV2KPatch, Split

        split = Split.from_string(mode)
        dataset = DIV2KPatch(config.DATA.DATA_PATH, split, transform=transform,
                             with_negative=True, image_size=config.DATA.IMG_SIZE,
                             erosion_ratio=config.DATA.EROSION_RATIO)
        return dataset, 5 if split.is_train() else 10
    if name == "div2k_triplet":
        from vit_ed_tpu_torch.data.div2k import Div2kPatchTriplet, Split

        split = Split.from_string(mode)
        dataset = Div2kPatchTriplet(config.DATA.DATA_PATH, split, transform=transform,
                                    with_negative=True, image_size=config.DATA.IMG_SIZE,
                                    erosion_ratio=config.DATA.EROSION_RATIO)
        return dataset, 5 if split.is_train() else 10
    if name == "pajigsaw":
        from vit_ed_tpu_torch.data.pajigsaw import Pajigsaw, Split

        dataset = Pajigsaw(config.DATA.DATA_PATH, Split.from_string(mode),
                           transform=transform, image_size=config.DATA.IMG_SIZE)
        return dataset, 1
    if name == "michigan":
        from vit_ed_tpu_torch.data.michigan import MichiganDataset, Split

        split = Split.from_string(mode)
        dataset = MichiganDataset(config.DATA.DATA_PATH, split, transforms=transform)
        return dataset, 3 if split.is_train() else 1
    if name == "geshaem":
        from vit_ed_tpu_torch.data.geshaem import GeshaemPatch, Split

        dataset = GeshaemPatch(config.DATA.DATA_PATH, Split.from_string(mode),
                               transform=transform)
        return dataset, 1
    raise NotImplementedError(f"We haven't supported {name}")
