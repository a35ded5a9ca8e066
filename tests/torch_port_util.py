"""Shared helper of the tests/test_torch_*.py files: one small BERT in the
JAX package and the same BERT in the port, with the same parameters."""
import numpy as onp

SMALL_BERT = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
                  num_heads=4, max_length=64, dropout=0.1)


def bert_pair(seed=0):
    """(jax_net, port_net, params): the JAX net initialized from ``seed``,
    its parameters as numpy, and the port net (CPU, f32) loaded from
    them through ``load_jax_params``."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert

    mx.random.seed(seed)
    jnet = jax_get_bert("bert_12_768_12", **SMALL_BERT)
    jnet.initialize(mx.init.Normal(0.05))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    tnet = get_bert("bert_12_768_12", device="cpu", **SMALL_BERT)
    load_jax_params(tnet, params)
    return jnet, tnet, params


def jax_forward(jnet, tokens, valid_length, token_types=None,
                masked_positions=None):
    import mxnet_tpu as mx
    arr = (lambda a: None if a is None else mx.np.array(a))
    out = jnet(arr(tokens), arr(token_types), arr(valid_length),
               arr(masked_positions))
    return [o.asnumpy() for o in out]


def inputs(seed, B, T, valid):
    rng = onp.random.RandomState(seed)
    tokens = rng.randint(0, SMALL_BERT["vocab_size"], (B, T)).astype("int32")
    types = rng.randint(0, 2, (B, T)).astype("int32")
    return tokens, types, onp.asarray(valid, "int32")


TINY_GPT = dict(vocab_size=97, num_layers=2, units=32, hidden_size=48,
                num_heads=4, max_length=64, dropout=0.0)


def gpt_pair(seed=0, sigma=1.0, **cfg):
    """(jax_net, port_net, params): a small JAX GPT initialized from
    ``seed`` with ``Normal(sigma)`` (a strong init keeps greedy streams
    from collapsing to one token), its parameters as numpy, and the port
    GPT (CPU, f32) loaded from them through ``load_jax_params``."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.gpt import GPTModel as JGPT
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel

    cfg = dict(TINY_GPT, **cfg)
    mx.random.seed(seed)
    jnet = JGPT(**cfg)
    jnet.initialize(mx.init.Normal(sigma))
    jnet(mx.np.zeros((1, 4), dtype="int32"))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    tnet = GPTModel(**cfg)
    load_jax_params(tnet, params)
    tnet.eval()
    return jnet, tnet, params
