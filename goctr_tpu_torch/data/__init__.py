from goctr_tpu_torch.data.schema import (Column, MysqlScanner, SqliteScanner,
                                         TableScanner, parse_mysql_ddl)
from goctr_tpu_torch.data.fixture import generate_movielens_fixture
from goctr_tpu_torch.data.movielens import MovielensRec
from goctr_tpu_torch.data.ml20m import (SignalKnobs, build_derived_tables,
                                        generate_ml20m_fixture)
