from goctr_tpu_torch.models.base import SampleInfo, TrainSample, split_blocks
from goctr_tpu_torch.models.din import DIN
from goctr_tpu_torch.models.youtube_dnn import YoutubeDNN
from goctr_tpu_torch.models.mlp_tower import MLPTower
from goctr_tpu_torch.models.trainer import TrainedRanker, train_ranker
