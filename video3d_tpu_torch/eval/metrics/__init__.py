from video3d_tpu_torch.eval.metrics.bleu import Bleu
from video3d_tpu_torch.eval.metrics.cider import Cider
from video3d_tpu_torch.eval.metrics.rouge import Rouge
from video3d_tpu_torch.eval.metrics.meteor import Meteor
from video3d_tpu_torch.eval.metrics.meteor15 import Meteor15
