"""``mx.rnn``: symbolic RNN cells and the bucketed sentence iterator
(counterpart of mxnet_tpu/rnn/)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell,
                       ModifierCell)
from .io import BucketSentenceIter, encode_sentences

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell",
           "BucketSentenceIter", "encode_sentences"]
