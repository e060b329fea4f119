from goctr_tpu_torch.embedding.dictionary import Dictionary
from goctr_tpu_torch.embedding.word2vec import Word2Vec, Word2VecOptions
from goctr_tpu_torch.embedding.store import (
    EmbeddingMap, load_embedding_map, save_embedding_map, train_embedding,
)
from goctr_tpu_torch.embedding.search import Searcher
