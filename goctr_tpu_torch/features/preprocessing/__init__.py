from goctr_tpu_torch.features.preprocessing.data import (
    Binarizer, IncrementalMeanVar, KernelCenterer, MaxAbsScaler, MinMaxScaler,
    Normalizer, PolynomialFeatures, PowerTransformer, QuantileTransformer,
    RobustScaler, Shuffler, StandardScaler,
)
from goctr_tpu_torch.features.preprocessing.label import (
    LabelBinarizer, LabelEncoder, MultiLabelBinarizer,
)
from goctr_tpu_torch.features.preprocessing.extras import (
    FunctionTransformer, Imputer, KBinsDiscretizer, OneHotEncoder, PCA,
)
