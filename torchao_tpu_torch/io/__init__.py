from torchao_tpu_torch.io.native_loader import (  # noqa: F401
    load_raw_checkpoint,
    native_loader_available,
    save_raw_checkpoint,
)
from torchao_tpu_torch.io.tokenizer import BpeTokenizer, train_byte_bpe  # noqa: F401
