from agcn_tpu_torch.infer.preprocess import InferencePreprocessor, StreamBuffer
from agcn_tpu_torch.infer.realtime import ActionRecognition, filter_logits
from agcn_tpu_torch.infer.serving import BatchedStreamServer

__all__ = ["InferencePreprocessor", "StreamBuffer", "ActionRecognition",
           "filter_logits", "BatchedStreamServer"]
