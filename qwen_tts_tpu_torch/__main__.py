"""``python -m qwen_tts_tpu_torch``: the ``qwen-tts`` command line
(``cli.py``); ``--help`` lists its flags."""

import sys

from qwen_tts_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
