from goctr_tpu_torch.recommend.rcmd import (
    Context, Stage, Sample, ItemScore, RankerFitter, Train, Rank,
    BatchPredict, get_sample, get_sample_vector,
    ITEM_EMB_DIM, ITEM_EMB_WINDOW, USER_BEHAVIOR_LEN,
)
