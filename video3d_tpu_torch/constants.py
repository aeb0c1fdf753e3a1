"""Shared protocol constants.

These values are the multimodal splice / loss-masking wire protocol the
data pipeline and model agree on; they must equal the reference's
(llava/constants.py:7-14) for checkpoint and dataset
interoperability: the tokenizer emits IMAGE_TOKEN_INDEX sentinels where
per-frame visual tokens get spliced, and IGNORE_INDEX masks loss.

The port's own copy of ``video3d_tpu/constants.py`` (the port imports
nothing of the JAX package).
"""

# loss masking (HF convention)
IGNORE_INDEX = -100

# splice sentinel: '<image>' tokenizes to this id (mm_utils.py:341-360)
IMAGE_TOKEN_INDEX = -200

# token strings
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# task tokens added by the 3D recipe (train_3d.py:1697-1713)
GROUND_TOKEN = "<ground>"
COORD_TOKEN = "<coord>"

# serving heartbeat protocol (controller worker-expiry contract)
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15
