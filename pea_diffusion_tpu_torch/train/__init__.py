from .kd import KDModels, KDState, kd_loss, make_train_step, teacher_encode_prompt
from .trainer import KDTrainer, export_adapter, import_adapter

__all__ = ["KDModels", "KDState", "kd_loss", "make_train_step", "teacher_encode_prompt",
           "KDTrainer", "export_adapter", "import_adapter"]
