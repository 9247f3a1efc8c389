"""Dataset factory (``vit_ed_tpu/data/build.py``): returns
``(dataset, repeat)`` where ``repeat`` multiplies the epoch length. Only
``hisfrag20`` is ported; the other datasets wait for their entries
(ROADMAP queue A item 8)."""

from __future__ import annotations


def build_dataset(mode, config, transforms):
    name = config.DATA.DATASET
    if name != "hisfrag20":
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP queue A item 8); "
            f"only 'hisfrag20' is")
    from vit_ed_tpu_torch.data.hisfrag import HisFrag20, Split

    dataset = HisFrag20(config.DATA.DATA_PATH, Split.from_string(mode),
                        transform=transforms[mode])
    return dataset, 3
