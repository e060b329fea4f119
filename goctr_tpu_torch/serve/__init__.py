from goctr_tpu_torch.serve.api import RecApiServer, start_http_api
